#!/usr/bin/env python3
"""The fused retrieval kernel (``gam_retrieve`` f32, ``gam_retrieve_q`` int8)
on one GPU, at the shapes of ``chip_smoke.py``'s retrieval slice: build
facts, agreement with the plain versions, paired times against the dense
route, and the floors at each shape.

    python3 tools/retrieve_sweep.py [--rounds 3] [--ablate]

1. Compiles ``gam_retrieve.cu`` with the port's ``nvcc`` flags and
   ``-Xptxas -v`` and prints each kernel's registers, spills and static
   shared memory, and the count of 1-bit tensor-core instructions
   (``BMMA``, or ``IMMA``) and of ``POPC`` that ``cuobjdump -sass`` finds in
   each (where the toolkit has ``cuobjdump``).
2. Builds gam_mf-1M as ``chip_smoke.py`` does (1,048,576 cluster-sorted unit
   rows, k 10, parse_tree, threshold 0.2, bucket = the longest list) on the
   ``gam-device`` backend, and a delta-sized catalog (its first 16,384 rows,
   bn 256, as the service's delta segment builds it).  Shapes: Q 8, 64 and
   256 at kappa 10 (f32) and pools 40, 128 and 256 (int8), min_overlap 2
   and 0 (the exact path).  At each shape the kernel is held to its plain
   version (rows, counts and skip map exact, scores within 4 ulp; the plain
   version once, timed), then timed ``--rounds`` times in turns with the
   dense route (``gam_score`` over the candidate masks, then ``topk_desc``):
   kernel, dense, kernel.  Each row prints the route the kernel took, the
   floors (candidate and dense f32 operations at 67 TFLOP/s, overlaps by
   ``__popc`` at 16 a clock an SM, the bytes of one pass over the kept
   blocks and of Q / Q_t passes at 3.35 TB/s) and the times.
3. At Q 256 (kappa 10, pool 40): copies of the kernel with other routes
   (``VARIANTS``: the overlaps by ``__popc`` on the CUDA cores, and the
   wide route's warp-per-query kernel at every shape), each held to the
   default's answers and timed in turns with it (default, copy, default).
4. With ``--ablate``: copies of ``gam_retrieve.cu`` with parts of the fast
   route's work cut out (``ABLATIONS``: the overlaps, the scoring, the
   top-kappa appends and merges, the staging of item tiles, the decode of
   their rows), each built and timed in turns with the kernel at Q 256
   (kappa 10 and pool 40).  Their outputs are wrong by design and are not
   checked; a cut that zeroes the scores (scoring, decode) also empties
   most of the top-kappa work.

Prints the card's name and power limit and one JSON line per measurement.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

POPC_PER_CLOCK_SM = 16         # sm_90 32-bit population counts
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# Cuts from the fast route (text of gam_retrieve.cu, stand-in).
_NO_OVERLAP = [("        mma_and_popc(ov[n], a, lo[item], hi[item]);",
                "        ov[n][0] = ov[n][1] = ov[n][2] = ov[n][3] = "
                "min_overlap;")]
_NO_SCORE = [("      for (int d = 0; d < L.k4; d += 4) {",
              "      for (int d = 0; d < 0; d += 4) {")]
_NO_TOPK = [("          const int pos = atomicAdd(sn + row, 1);\n"
             "          ss[pos * QT + row] = s;\n"
             "          sr[pos * QT + row] = item;\n"
             "          if (pos >= merge_at) need_merge[it & 1] = it;",
             "          if (s == 1.25e-38f) sn[row] = 0;")]
_NO_STAGE = [("    if (pb < b1) {\n      issue((it + FSTAGES - 1) % FSTAGES, pb, pt);",
              "    if (false) {\n      issue((it + FSTAGES - 1) % FSTAGES, pb, pt);"),
             ("    if (pb < b1) {\n      issue(s, pb, pt);",
              "    if (false) {\n      issue(s, pb, pt);")]
_NO_DECODE = [("    decode_own(it % FSTAGES, cb, ct, vs);\n", "")]
ABLATIONS = {"no_overlap": _NO_OVERLAP, "no_score": _NO_SCORE,
             "no_topk": _NO_TOPK, "no_stage": _NO_STAGE,
             "no_decode": _NO_DECODE}


# Other routes, held to the default's answers and timed in turns with it:
# the overlaps by __popc on the CUDA cores, and the wide route's
# warp-per-query kernel at every shape.
_MMA_LOOP = ('    for (int c = 0; c < chunks; ++c) {\n'
             '      const int w = 8 * c + t4;\n'
             '      uint32_t a[4];\n'
             '      a[0] = qb_s[r0 * L.qb_ld + w];\n'
             '      a[1] = qb_s[r1 * L.qb_ld + w];\n'
             '      a[2] = qb_s[r0 * L.qb_ld + w + 4];\n'
             '      a[3] = qb_s[r1 * L.qb_ld + w + 4];\n'
             '      const int32_t* lo = brow(w);\n'
             '      const int32_t* hi = brow(w + 4);\n'
             '#pragma unroll\n'
             '      for (int n = 0; n < 4; ++n) {\n'
             '        const int item = ibase + 8 * n + g;\n'
             '        mma_and_popc(ov[n], a, lo[item], hi[item]);\n'
             '      }\n'
             '    }\n'
             '\n')
_POPC_LOOP = ('    for (int w = 0; w < words; ++w) {\n'
             '      const int32_t qa = qb_s[r0 * L.qb_ld + w], qc = qb_s[r1 * L.qb_ld + w];\n'
             '#pragma unroll\n'
             '      for (int n = 0; n < 4; ++n)\n'
             '#pragma unroll\n'
             '        for (int e = 0; e < 2; ++e) {\n'
             '          const int32_t ib = brow(w)[ibase + 8 * n + 2 * t4 + e];\n'
             '          ov[n][e] += __popc(qa & ib);\n'
             '          ov[n][2 + e] += __popc(qc & ib);\n'
             '        }\n'
             '    }\n'
             '\n')
_FAST_IF = ("  if (kappa <= SMEM_KAPPA && L.total <= MAX_SMEM && "
            "L.tn * k < 65536) {")
VARIANTS = {"popc": [(_MMA_LOOP, _POPC_LOOP)],
            "wide": [(_FAST_IF, "  if (false) {")]}


def _nvcc(src: Path, so: Path, *extra: str) -> str:
    """Compile ``src`` as the port builds its kernels; -> nvcc's stderr."""
    from repro_torch.kernels import _build
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I",
                          str(_build.CSRC), "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc {src.name}:\n{res.stderr}")
    return res.stderr


def build_copies(cuts_by_name: dict, tmp: str) -> dict:
    """Copies of gam_retrieve.cu with each entry's cuts, built -> name ->
    loaded library."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "gam_retrieve.cu").read_text()
    libs = {}
    for name, cuts in cuts_by_name.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise SystemExit(f"{name}: gam_retrieve.cu no longer holds "
                                 f"{old.splitlines()[0]!r}")
            text = text.replace(old, new)
        cu = Path(tmp) / f"{name}.cu"
        cu.write_text(text)
        _nvcc(cu, Path(tmp) / f"lib{name}.so")
        libs[name] = ctypes.CDLL(str(Path(tmp) / f"lib{name}.so"))
    return libs


class using:
    """Route gam_retrieve's launches through ``lib`` inside the block."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from repro_torch.kernels import _build
        gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
        self.real = _build.library("gam_retrieve")
        _build._loaded["gam_retrieve"] = self.lib
        gr._plans.clear()

    def __exit__(self, *exc):
        from repro_torch.kernels import _build
        gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
        _build._loaded["gam_retrieve"] = self.real
        gr._plans.clear()


def _demangle(names: list[str]) -> dict[str, str]:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True).stdout
        return dict(zip(names, out.splitlines()))
    except OSError:
        return {n: n for n in names}


def ptxas_report() -> None:
    from repro_torch.kernels import _build
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "libgam_retrieve.so"
        stderr = _nvcc(_build.CSRC / "gam_retrieve.cu", so, "-Xptxas", "-v")
        facts: dict[str, str] = {}
        kernel = None
        for line in stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            elif kernel and ("registers" in line or "spill" in line):
                facts[kernel] = (facts.get(kernel, "") + " "
                                 + line.split(":", 1)[-1].strip())
        counts: dict[str, dict[str, int]] = {}
        dump = Path(_build._nvcc()).with_name("cuobjdump")
        if dump.exists():
            sass = subprocess.run([str(dump), "-sass", str(so)],
                                  capture_output=True, text=True).stdout
            fn = None
            for line in sass.splitlines():
                m = re.search(r"Function : (\w+)", line)
                if m:
                    fn = m.group(1)
                    counts[fn] = {"BMMA": 0, "IMMA": 0, "POPC": 0}
                elif fn:
                    for op in counts[fn]:
                        if re.search(rf"\b{op}\b", line):
                            counts[fn][op] += 1
        else:
            print("sass gam_retrieve: cuobjdump not in the toolkit")
        names = _demangle(list(facts))
        for mangled, text in facts.items():
            print(f"ptxas {names[mangled]}: {text.strip()} "
                  f"sass {json.dumps(counts.get(mangled))}")


def floors(q: int, k: int, words: int, kept_rows: int, n_cand: int,
           cand_rows: int, q_tile: int, quantized: bool, clock_hz: float,
           sms: int) -> dict:
    """The least times of one call at this shape (ms), each by one limit."""
    row_bytes = k if quantized else 4 * k
    one_pass = kept_rows * (4 * words + 2 + row_bytes)
    passes = -(-q // q_tile) if q_tile else q
    fma_cand = 2 * k * n_cand + (k * cand_rows if quantized else 0)
    return {
        "fma_candidates_ms": fma_cand / F32_FLOPS * 1e3,
        "fma_dense_ms": 2 * k * q * kept_rows / F32_FLOPS * 1e3,
        "popc_ms": q * kept_rows * words
        / (POPC_PER_CLOCK_SM * sms * clock_hz) * 1e3,
        "bytes_one_pass_ms": one_pass / HBM_BYTES_PER_S * 1e3,
        "bytes_q_tile_passes_ms": passes * one_pass / HBM_BYTES_PER_S * 1e3,
    }


def device_ms(torch, fn, calls: int = 5) -> dict:
    """Device time of each kernel ``fn`` launches, per call (torch.profiler),
    and the host's time to enqueue one call."""
    import time

    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            name = re.sub(r"\(.*", "", e.key)[:48]
            out[name] = out.get(name, 0.0) + t / calls / 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return {"device_ms": dict(sorted(out.items(), key=lambda kv: -kv[1])[:6]),
            "host_enqueue_ms": host}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--ablate", action="store_true",
                    help="also time copies of the kernel with parts cut out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("retrieve_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.mapping import GamConfig, sparse_map
    from repro_torch.core.retrieval import topk_desc
    gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
    gs = importlib.import_module("repro_torch.kernels.gam_score")
    from repro_torch.retriever import RetrieverSpec, open_retriever
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    clock_hz = float(re.findall(r"([\d.]+) MHz", smi)[-1]) * 1e6
    ptxas_report()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    items, centers = cs.clustered_catalog(cs.N_ITEMS, cs.K, cs.N_CLUSTERS,
                                          cs.SIGMA, seed=cs.N_ITEMS)
    reqs = cs.requests(centers, 2, cs.BATCH, cs.SIGMA, seed=0)
    cfg = GamConfig(k=cs.K, scheme="parse_tree", threshold=cs.THRESHOLD)
    tau, vals = sparse_map(torch.as_tensor(items, device=dev), cfg)
    nz = (vals != 0).cpu().numpy()
    bucket = int(np.bincount(tau.cpu().numpy()[nz], minlength=cfg.p).max())
    spec = RetrieverSpec(cfg=cfg, backend="gam-device",
                         min_overlap=cs.MIN_OVERLAP, kappa=cs.KAPPA,
                         bucket=bucket, quantize="int8",
                         rerank_factor=cs.RERANK)
    r = open_retriever(spec, items=items, device="cuda")
    meta = r._retrieve_meta
    f32 = r._items_dev
    u_all = torch.as_tensor(reqs[1], device=dev)
    qt_all, qm_all = r._map(u_all)
    # the delta's size: its first 16,384 rows, bn 256, as DeltaSegment
    # builds its metadata
    n_delta = 1 << 14
    dmeta = gr.build_retrieval_meta(
        tau[:n_delta], vals[:n_delta] != 0, cfg.p, n_rows=n_delta, bn=256,
        factors=f32[:n_delta], quantize="int8", device=dev)

    def masks_for(qt, qm, mo, rows_meta):
        """(Q, n_rows) candidate masks as the kernel defines them."""
        q = qt.shape[0]
        if mo == 0:
            return torch.ones((q, rows_meta.n_rows), dtype=torch.bool,
                              device=dev)
        qb = gr.pack_patterns(qt, qm, rows_meta.p)
        ov = torch.zeros((q, rows_meta.n_rows), dtype=torch.int32,
                         device=dev)
        for w in range(rows_meta.words):
            ov += gr.popcount32(qb[:, w, None]
                                & rows_meta.item_bits_t[w, None,
                                                        :rows_meta.n_rows])
        spill = rows_meta.spill8[0, :rows_meta.n_rows] != 0
        return (ov >= mo) | spill[None]

    def run_shape(name, q, kappa, mo, quantized, delta=False):
        m = dmeta if delta else meta
        fac = f32[:n_delta] if delta else f32
        u, qt, qm = u_all[:q], qt_all[:q], qm_all[:q]
        kw = dict(min_overlap=mo)
        if quantized:
            kern = lambda: gr.gam_retrieve_q(u, qt, qm, m, kappa, **kw)  # noqa: E731
            plain = lambda: gr.gam_retrieve_q_plain(u, qt, qm, m, kappa, **kw)  # noqa: E731
        else:
            kern = lambda: gr.gam_retrieve(u, fac, qt, qm, m, kappa, **kw)  # noqa: E731
            plain = lambda: gr.gam_retrieve_plain(u, fac, qt, qm, m, kappa, **kw)  # noqa: E731
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        for field in ("rows", "blk_counts", "skipped"):
            if not torch.equal(getattr(got, field), getattr(want, field)):
                raise SystemExit(f"{name}: {field} differ from the plain "
                                 "version")
        ulp = cs.max_ulp(got.vals.cpu().numpy(), want.vals.cpu().numpy())
        if ulp > cs.ULP:
            raise SystemExit(f"{name}: scores {ulp} ulp from the plain version")
        plan = gr.retrieve_plan(q, cs.K, m.words, kappa, m.n_blocks,
                                quantized, dev)
        masks = masks_for(qt, qm, mo, m)
        dense = lambda: topk_desc(gs.gam_score(u, fac, masks), kappa)  # noqa: E731
        kept = ~got.skipped
        kept_rows = int(kept.any(dim=0).sum()) * m.bn
        n_cand = int(got.blk_counts.sum())
        cand_rows = int(masks.any(dim=0).sum())
        row = {"row": name, "q": q, "kappa": kappa, "min_overlap": mo,
               "n_rows": m.n_rows, "bn": m.bn, "plan": plan,
               "candidates": n_cand, "max_ulp": ulp,
               "floors": floors(q, cs.K, m.words, kept_rows, n_cand,
                                cand_rows, plan["q_tile"], quantized,
                                clock_hz, sms),
               "plain_ms": cs.time_ms(torch, plain, 1),
               **device_ms(torch, kern)}
        print(json.dumps(row))
        for rnd in range(args.rounds):
            a = cs.time_ms(torch, kern, 20)
            d = cs.time_ms(torch, dense, 20)
            b = cs.time_ms(torch, kern, 20)
            print(json.dumps({"row": name, "round": rnd, "ms": [a, b],
                              "dense_ms": d}))
        del masks

    for q in (8, 64, 256):
        run_shape(f"gam_retrieve Q{q} kappa10 mo2", q, 10, 2, False)
    run_shape("gam_retrieve Q256 kappa10 mo0", 256, 10, 0, False)
    for pool in (40, 128, 256):
        run_shape(f"gam_retrieve_q Q256 pool{pool} mo2", 256, pool, 2, True)
    for q in (8, 64):
        run_shape(f"gam_retrieve_q Q{q} pool40 mo2", q, 40, 2, True)
    run_shape("gam_retrieve_q Q256 pool40 mo0", 256, 40, 0, True)
    run_shape("gam_retrieve delta16k Q256 kappa10 mo2", 256, 10, 2, False,
              delta=True)
    run_shape("gam_retrieve_q delta16k Q256 pool40 mo2", 256, 40, 2, True,
              delta=True)

    # variants of the kernel at the main shape, in turns with the default
    u, qt, qm = u_all, qt_all, qm_all

    def main_f32():
        return gr.gam_retrieve(u, f32, qt, qm, meta, 10, min_overlap=2)

    def main_i8():
        return gr.gam_retrieve_q(u, qt, qm, meta, 40, min_overlap=2)

    want32, want8 = main_f32(), main_i8()
    masks = masks_for(qt, qm, 2, meta)
    print(json.dumps({"row": "gam_score Q256 (the dense oracle)",
                      "ms": cs.time_ms(torch, lambda: gs.gam_score(
                          u, f32, masks), 20)}))
    del masks
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_copies(VARIANTS, tmp)
        for name, lib in libs.items():
            with using(lib):
                for fn, want in ((main_f32, want32), (main_i8, want8)):
                    got = fn()
                    for field in ("rows", "blk_counts", "skipped"):
                        if not torch.equal(getattr(got, field),
                                           getattr(want, field)):
                            raise SystemExit(f"variant {name}: {field} "
                                             "differ")
        for rnd in range(args.rounds):
            for name, lib in libs.items():
                out = {"row": f"variant {name}", "round": rnd}
                for label, fn in (("f32", main_f32), ("int8", main_i8)):
                    a = cs.time_ms(torch, fn, 20)
                    with using(lib):
                        v = cs.time_ms(torch, fn, 20)
                    b = cs.time_ms(torch, fn, 20)
                    out[label] = {"default_ms": [a, b], "variant_ms": v}
                print(json.dumps(out))
        if args.ablate:
            libs = build_copies(ABLATIONS, tmp)
            for rnd in range(args.rounds):
                for label, fn in (("gam_retrieve Q256 kappa10", main_f32),
                                  ("gam_retrieve_q Q256 pool40", main_i8)):
                    out = {"row": f"{label} ablations", "round": rnd,
                           "kernel": cs.time_ms(torch, fn, 20)}
                    for name, lib in libs.items():
                        with using(lib):
                            out[name] = cs.time_ms(torch, fn, 20)
                    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
