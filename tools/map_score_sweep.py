#!/usr/bin/env python3
"""The map kernel (``tess_project``) and the dense masked scorer
(``gam_score``) on one GPU, at the shapes their main paths give them: build
facts, agreement, and times in turns against the kernels' first designs.

    python3 tools/map_score_sweep.py [--rounds 3] [--ablate]

1. Compiles ``csrc/tess_project.cu`` and ``csrc/gam_score.cu``, and the first
   designs kept in ``tools/first_designs/`` (one thread a row with its row in
   local memory, or one CTA a row ranking by counting; 32 x 32 score tiles),
   with the port's ``nvcc`` flags and ``-Xptxas -v``, and prints each
   kernel's registers, spills and static shared memory.  The first designs
   are built here only: the port never builds or launches them.
2. Inputs, made on the card from seeds: gam_mf-1M's catalog as
   ``chip_smoke.py`` builds it (1,048,576 cluster-sorted unit rows, k 10,
   thresholded at 0.2) and 256 of its queries; the service's compaction
   slice (its first 262,144 rows) and rebuild (1,052,672 rows); the GAM
   head's vocab (32,000 unit rows at k 512, thresholded at 1.5 / sqrt(512))
   and one step's 8 hidden states.
3. At each shape the kernel is held to its first design (``tess_project``:
   pattern and ``a`` equal; ``gam_score``: scores equal bit for bit, the same
   fma chain) and to its plain version (patterns equal except certified
   near-ties, counted; scores within 1e-6, differing elements counted), then
   timed ``--rounds`` times in turns: first design, kernel, kernel, first
   design, each eagerly (CUDA events around a call, the host's launch
   included: median of 20) and in a CUDA graph (20 calls, 5 at the oracle's
   shape, replayed: the device time).  ``gam_score`` is timed beside
   ``torch.where(mask != 0, u @ v.T, NEG)`` with TF32 off, two PyTorch calls
   that compute the same function (a yardstick the port never calls).
4. The host: ``tess_project`` at 256 x 10 as an eager call, through the
   wrapper as it was (its ``ctypes`` signature set and the device entered on
   every call) and as it is, in turns.
5. With ``--ablate``: copies of the two sources with one part cut out
   (``TESS_CUTS``, ``SCORE_CUTS``) and variants (``TESS_VARIANTS``: the
   narrow route ranking by counting; ``SCORE_VARIANTS``: other batches of
   mask words, fewer registers, plain stores, other rings and item counts
   of the staged route), each built and timed in turns
   with the kernel.  The cuts' outputs are wrong by design and are not
   checked; each variant must equal the kernel at every shape.

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

FIRST = ROOT / "tools" / "first_designs"

# Cuts (text of the two sources, stand-in), timed only.
TESS_CUTS = {
    "no_sort": [("  sort_values_desc<K>(v);\n", ""),
                ("  warp_sort_desc<E>(v, lane);\n", "")],
    "no_serial_sum": [
        ("    run = __fadd_rn(run, __uint_as_float(v[t]));",
         "    run = __uint_as_float(v[t]);"),
        ("  for (int l = 0; l < lanes; ++l) {",
         "  for (int l = lane; l < lane + 1; ++l) {")],
    "no_divide": [
        ("__fdiv_rn(run, c_sqrt[t]);", "run * c_sqrt[t];"),
        ("__fdiv_rn(run[s], __fsqrt_rn((float)(t + 1)));", "run[s];")],
    "scalar_stores": [("  const int pchunks = n >> 4;",
                       "  const int pchunks = 0;"),
                      ("  const int achunks = n >> 2;",
                       "  const int achunks = 0;")],
}
SCORE_CUTS = {
    "no_fma": [("        for (int d4 = 0; d4 < K4; ++d4) {",
                "        for (int d4 = 0; d4 < 0; ++d4) {"),
               ("    for (int d = 0; d < dn; d += 4) {",
                "    for (int d = 0; d < 0; d += 4) {")],
    "no_mask_read": [("          m[j] = __ldcs((const unsigned int*)mp);",
                      "          m[j] = 0x01010101u;"),
                     ("__ldcs(mask + idx) != 0", "true")],
    "scalar_stores": [("        if (vec) {\n          __stcs((float4*)op",
                       "        if (false) {\n          __stcs((float4*)op")],
    "no_staging": [("      stage(next, next % STG_STAGES);",
                    "      cp_async_commit();"),
                   ("      stage(c, c);", "      cp_async_commit();")],
}
# Variants, which must give the kernel's answers.  Register route: batches
# of 4 or 16 rows' mask words instead of 8; at most 64 registers a thread (8
# CTAs an SM); plain stores instead of streaming ones (__stcs).  Staged
# route: a ring of 2 or 4 stages instead of 3; two items a thread (256 a
# CTA) instead of one.
SCORE_VARIANTS = {
    "stages2": [("#define STG_STAGES 3", "#define STG_STAGES 2")],
    "stages4": [("#define STG_STAGES 3", "#define STG_STAGES 4")],
    "items2": [("#define STG_ITEMS 1", "#define STG_ITEMS 2")],
    "mask_rows4": [("#define REG_MROWS 8", "#define REG_MROWS 4")],
    "mask_rows16": [("#define REG_MROWS 8", "#define REG_MROWS 16")],
    "regs64": [("__global__ void __launch_bounds__(REG_THREADS)",
                "__global__ void __launch_bounds__(REG_THREADS, 8)")],
    "plain_stores": [("__stcs((float4*)op, make_float4(o[0], o[1], o[2], "
                      "o[3]));",
                      "*(float4*)op = make_float4(o[0], o[1], o[2], o[3]);")],
}
# The narrow route ranking by counting (k(k-1)/2 compares, then k^2
# selects into rank order) instead of the sorting network: same answers.
_COUNT_SORT = '''template <int K>
__device__ __forceinline__ void count_sort_values_desc(uint32_t (&v)[K]) {
  int rank[K];
#pragma unroll
  for (int i = 0; i < K; ++i) rank[i] = 0;
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) {
      const bool b = v[j] >= v[i];
      rank[i] += b;
      rank[j] += !b;
    }
  uint32_t out[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    out[t] = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) out[t] = rank[i] == t ? v[i] : out[t];
  }
#pragma unroll
  for (int t = 0; t < K; ++t) v[t] = out[t];
}

// One row of the narrow route'''
TESS_VARIANTS = {"count_rank": [("// One row of the narrow route", _COUNT_SORT),
                                ("  sort_values_desc<K>(v);",
                                 "  count_sort_values_desc<K>(v);")]}


def _nvcc(src: Path, so: Path, *extra: str) -> str:
    """Compile ``src`` as the port builds its kernels; -> nvcc's stderr."""
    from repro_torch.kernels import _build
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I",
                          str(_build.CSRC), "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc {src.name}:\n{res.stderr}")
    return res.stderr


def build_copies(jobs: dict, tmp: str) -> dict:
    """Copies of csrc/<name>.cu with cuts applied, one ``nvcc`` each, all
    started together.  ``jobs``: (name, tag) -> cuts; -> (name, tag) ->
    loaded library."""
    from repro_torch.kernels import _build
    procs = {}
    for (name, tag), cuts in jobs.items():
        text = (_build.CSRC / f"{name}.cu").read_text()
        for old, new in cuts:
            if old not in text:
                raise SystemExit(f"{tag}: {name}.cu no longer holds "
                                 f"{old.splitlines()[0]!r}")
            text = text.replace(old, new)
        cu = Path(tmp) / f"{name}_{tag}.cu"
        cu.write_text(text)
        so = Path(tmp) / f"lib{name}_{tag}.so"
        procs[(name, tag)] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {key}:\n{err}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


class using:
    """Route the wrapper of ``name`` through ``lib`` inside the block."""

    def __init__(self, name: str, lib):
        self.name, self.lib = name, lib

    def __enter__(self):
        from repro_torch.kernels import _build
        self.real = _build.library(self.name)
        _build._loaded[self.name] = self.lib

    def __exit__(self, *exc):
        from repro_torch.kernels import _build
        _build._loaded[self.name] = self.real


def ptxas_report(tmp: str) -> None:
    from repro_torch.kernels import _build
    for tag, src in (("kernel", _build.CSRC / "tess_project.cu"),
                     ("kernel", _build.CSRC / "gam_score.cu"),
                     ("first design", FIRST / "tess_project.cu"),
                     ("first design", FIRST / "gam_score.cu")):
        stderr = _nvcc(src, Path(tmp) / "ptxas.so", "-Xptxas", "-v")
        kernel = None
        for line in stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            elif kernel and "registers" in line:
                facts = line.split(":", 1)[-1].strip()
                print(f"ptxas {tag} {src.name} {kernel}: {facts}")
            elif kernel and "spill" in line:
                print(f"ptxas {tag} {src.name} {kernel}: "
                      f"{line.split(':', 1)[-1].strip()}")


def tess_as_before(torch, z):
    """The ``tess_project`` wrapper as it was: the ``ctypes`` signature set
    and the device entered on every call."""
    from repro_torch.kernels import _build
    tp = importlib.import_module("repro_torch.kernels.tess_project")
    if z.device.type != "cuda":
        raise ValueError("needs a CUDA tensor")
    if z.dtype != torch.float32 or z.dim() != 2 or not z.is_contiguous():
        raise ValueError("takes a contiguous (B, k) float32 tensor")
    b, k = z.shape
    if not 1 <= k <= tp.TESS_MAX_K:
        raise ValueError("k out of range")
    pat = torch.empty((b, k), dtype=torch.int8, device=z.device)
    a = torch.empty((b, k), dtype=torch.float32, device=z.device)
    fn = _build.library("tess_project").tess_project_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        _build.check(fn(z.data_ptr(), pat.data_ptr(), a.data_ptr(), b, k,
                        stream), "tess_project")
    return pat, a


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--ablate", action="store_true",
                    help="also time copies with parts cut out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("map_score_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import _build
    gs = importlib.import_module("repro_torch.kernels.gam_score")
    tp = importlib.import_module("repro_torch.kernels.tess_project")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    ptxas_report(tmp)
    _build.build_all()
    first = {}
    for name in ("tess_project", "gam_score"):
        _nvcc(FIRST / f"{name}.cu", Path(tmp) / f"lib{name}_first.so")
        first[name] = ctypes.CDLL(str(Path(tmp) / f"lib{name}_first.so"))

    # ------------------------------------------------------------ inputs
    items, centers = cs.clustered_catalog(cs.N_ITEMS, cs.K, cs.N_CLUSTERS,
                                          cs.SIGMA, seed=cs.N_ITEMS)
    users = cs.requests(centers, 1, cs.BATCH, cs.SIGMA, seed=0)[0]
    cat = torch.as_tensor(items, device=dev)
    cat_t = torch.where(cat.abs() >= cs.THRESHOLD, cat, 0.0)
    u_t = torch.as_tensor(users, device=dev)
    q_t = torch.where(u_t.abs() >= cs.THRESHOLD, u_t, 0.0)
    gen = torch.Generator(dev).manual_seed(512)
    d_head = 512
    vocab = torch.randn((32000, d_head), device=dev, generator=gen)
    vocab /= vocab.norm(dim=1, keepdim=True)
    hidden = torch.randn((8, d_head), device=dev, generator=gen)
    hidden /= hidden.norm(dim=1, keepdim=True)
    head_thr = 1.5 / d_head ** 0.5
    tess_shapes = {
        "1048576x10 (catalog)": cat_t,
        "256x10 (a request's queries)": q_t,
        "262144x10 (compaction slice)": cat_t[:1 << 18].contiguous(),
        "1052672x10 (rebuild)": torch.cat([cat_t, cat_t[:4096]]),
        "32000x512 (GAM head build)": torch.where(
            vocab.abs() >= head_thr, vocab, 0.0),
        "8x512 (GAM head step)": torch.where(
            hidden.abs() >= head_thr, hidden, 0.0),
    }
    mask_oracle = torch.rand((cs.BATCH, cs.N_ITEMS), device=dev,
                             generator=gen) < 0.433
    mask_head = torch.rand((8, 32000), device=dev, generator=gen) < 0.994
    score_shapes = {
        "256x1048576 k10 (oracle)": (u_t, cat, mask_oracle),
        "8x32000 k512 (GAM head step)": (hidden, vocab, mask_head),
    }

    def dev_ms(fn, big=False):
        """Device time of one call: calls captured in a CUDA graph."""
        return cs.graph_ms(torch, fn, calls=5 if big else 20,
                           reps=5 if big else 10)

    def run_turns(label, kern, other, graph, big=False):
        for rnd in range(args.rounds):
            t = (lambda f: dev_ms(f, big)) if graph else (
                lambda f: cs.time_ms(torch, f, 20))
            a = t(other)
            b = t(kern)
            c = t(kern)
            d = t(other)
            print(json.dumps({"row": label, "round": rnd,
                              "graph": graph, "ms": [b, c],
                              "first_design_ms": [a, d]}))

    # --------------------------------------------------------- tess_project
    for label, z in tess_shapes.items():
        rows, k = z.shape
        pat, a = tp.tess_project(z)
        with using("tess_project", first["tess_project"]):
            pat1, a1 = tp.tess_project(z)
        torch.cuda.synchronize()
        if not (torch.equal(pat, pat1) and torch.equal(a, a1)):
            raise SystemExit(f"tess_project {label}: differs from the first "
                             "design")
        pat_p, a_p = tp.tess_project_plain(z)
        diff = (pat != pat_p).any(dim=1).cpu().numpy()
        rows_diff = np.nonzero(diff)[0]
        if not cs.near_tie_rows(z[rows_diff].cpu().numpy()).all():
            raise SystemExit(f"tess_project {label}: rows differ from the "
                             "plain version and are not near-ties")
        same = torch.as_tensor(~diff, device=dev)
        if not torch.equal(a[same], a_p[same]):
            raise SystemExit(f"tess_project {label}: a differs")
        b_ms, b_by = cs.bound_ms(rows * k * 9, 3 * k * rows)
        print(json.dumps({"row": f"tess_project {label}",
                          "near_tie_rows": int(diff.sum()),
                          "bound_ms": b_ms, "bound_by": b_by,
                          "plain_ms": cs.time_ms(
                              torch, lambda z=z: tp.tess_project_plain(z),
                              1)}))

        def first_call(z=z):
            with using("tess_project", first["tess_project"]):
                return tp.tess_project(z)
        for graph in (False, True):
            run_turns(f"tess_project {label}",
                      lambda z=z: tp.tess_project(z), first_call, graph)

    # ------------------------------------------------------------ gam_score
    for label, (u, v, mask) in score_shapes.items():
        q, k = u.shape
        n = v.shape[0]
        got = gs.gam_score(u, v, mask)
        with using("gam_score", first["gam_score"]):
            got1 = gs.gam_score(u, v, mask)
        torch.cuda.synchronize()
        if not torch.equal(got, got1):
            raise SystemExit(f"gam_score {label}: differs from the first "
                             "design")
        want = gs.gam_score_plain(u, v, mask)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        n_diff = int((got != want).sum())
        del got1, want
        yard = lambda u=u, v=v, mask=mask: torch.where(  # noqa: E731
            mask != 0, u @ v.T, gs.NEG)
        yard_err = float((yard() - got).abs().max())
        b_ms, b_by = cs.bound_ms(q * k * 4 + n * k * 4 + q * n * 5,
                                 2 * k * int(mask.sum()))
        print(json.dumps({"row": f"gam_score {label}",
                          "elements_differing_from_plain": n_diff,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "plain_ms": cs.time_ms(
                              torch, lambda: gs.gam_score_plain(u, v, mask),
                              1),
                          "yardstick_max_abs_diff": yard_err}))
        del got

        def first_call(u=u, v=v, mask=mask):
            with using("gam_score", first["gam_score"]):
                return gs.gam_score(u, v, mask)
        big = "oracle" in label
        for graph in (False, True):
            run_turns(f"gam_score {label}", lambda u=u, v=v, mask=mask:
                      gs.gam_score(u, v, mask), first_call, graph, big)
        for rnd in range(args.rounds):
            print(json.dumps({"row": f"gam_score {label} yardstick "
                              "(matmul + where, two calls)", "round": rnd,
                              "ms": cs.time_ms(torch, yard, 20),
                              "graph_ms": dev_ms(yard, big)}))

    # ------------------------------------------------------- the host repair
    z = tess_shapes["256x10 (a request's queries)"]
    for rnd in range(args.rounds):
        a = cs.time_ms(torch, lambda: tess_as_before(torch, z), 50)
        b = cs.time_ms(torch, lambda: tp.tess_project(z), 50)
        c = cs.time_ms(torch, lambda: tp.tess_project(z), 50)
        d = cs.time_ms(torch, lambda: tess_as_before(torch, z), 50)
        print(json.dumps({"row": "tess_project 256x10 eager, wrapper",
                          "round": rnd, "ms": [b, c],
                          "wrapper_as_before_ms": [a, d]}))

    # ------------------------------------------------------------ ablations
    if args.ablate:
        jobs = {("tess_project", n): c
                for n, c in {**TESS_CUTS, **TESS_VARIANTS}.items()}
        jobs.update({("gam_score", n): c
                     for n, c in {**SCORE_CUTS, **SCORE_VARIANTS}.items()})
        copies = build_copies(jobs, tmp)
        # the variants must give the kernel's answers
        for (name, tag), lib in copies.items():
            if tag not in TESS_VARIANTS and tag not in SCORE_VARIANTS:
                continue
            inputs = ([(z,) for z in tess_shapes.values()]
                      if name == "tess_project" else score_shapes.values())
            fn = tp.tess_project if name == "tess_project" else gs.gam_score
            for x in inputs:
                want = fn(*x)
                with using(name, lib):
                    got = fn(*x)
                same = (all(map(torch.equal, got, want))
                        if name == "tess_project" else torch.equal(got, want))
                if not same:
                    raise SystemExit(f"variant {tag} differs from the kernel")
            del got, want
        cases = [("tess_project", label, False,
                  lambda z=z: tp.tess_project(z))
                 for label, z in tess_shapes.items()
                 if label.split(" ")[0] in ("1048576x10", "32000x512",
                                             "8x512")]
        cases += [("gam_score", label, "oracle" in label,
                   lambda x=x: gs.gam_score(*x))
                  for label, x in score_shapes.items()]
        for rnd in range(args.rounds):
            for name, label, big, fn in cases:
                out = {"row": f"{name} {label} ablations, in a CUDA graph",
                       "round": rnd, "kernel": dev_ms(fn, big)}
                for (lib_name, cut), lib in copies.items():
                    if lib_name != name:
                        continue
                    with using(name, lib):
                        out[cut] = dev_ms(fn, big)
                out["kernel_again"] = dev_ms(fn, big)
                print(json.dumps(out))
    tmp_dir.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
