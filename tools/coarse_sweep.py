#!/usr/bin/env python3
"""The coarse head scorer (``gam_coarse``) on one GPU: build facts,
agreement, and times in turns against its PR 14 design and a library
yardstick, with cuts that say what bounds it.

    python3 tools/coarse_sweep.py [--rounds 3] [--ablate] [--against FILE ...]

1. Compiles ``csrc/gam_coarse.cu`` and the PR 14 design kept in
   ``tools/first_designs/gam_coarse.cu`` (one thread a column, eight query
   rows a CTA, grid.y over B) with the port's ``nvcc`` flags and
   ``-Xptxas -v``, and prints each kernel's registers, spills and the
   card's count of resident CTAs an SM for each config of the plan.  The
   first design is built here only.
2. Inputs, made on the card from a seed: ternary patterns (d, V 32,000),
   h (B, d) normal, inv = 1/sqrt(nnz), at B 8 / d 2,048 (tinyllama's head),
   B 8 / d 512 (the GAM head's), B 1, 16, 32, 64 and 256 at d 2,048.
3. At each shape every design is held to the plain version within
   ``coarse_tolerance``, then timed ``--rounds`` times in turns (first
   design, kernel, [each other build twice,] kernel, first design), each as
   device time in a CUDA graph with the patterns warm in L2 (the same copy
   every call) and cold (calls walk copies whose total passes twice the
   50 MB L2).  ``--against FILE ...``: other builds of ``gam_coarse.cu``
   with the same entry points (earlier versions of it), each checked and
   timed in the same turns as ``against:FILE``.  The yardstick: ``torch.mm(h, patterns_f32) * inv`` on a
   pre-cast f32 copy, TF32 off (two calls; the port never calls it).
4. Pattern values: B 8, d 2,048 on uniform ternary patterns, on patterns
   13% nonzero (the GAM head's threshold, 1.5 / sqrt(d), leaves about that
   many) and on zeros, in turns (warm).
   Bytes: a copy of the kernel that counts the pattern bytes its CTAs
   stage (an atomic add a CTA at its end, in the copy only) against d V, at
   B 8, 64 and 256.
5. The host: an eager call through the wrapper as it was (the ``ctypes``
   signature set and the device entered on every call) and as it is.
6. The third term of h: on ``gam_coarse.third_term_probe``'s inputs (the
   answer in h's third bf16 term) at every config of the plan, the kernel's
   error against the f64 product beside that of a copy that keeps two terms
   (``TWO_TERMS``); the kernel must stay within an eighth of the two-term
   error, as ``chip_smoke.py`` asks, and the copy must not.
7. With ``--ablate``: copies of the source with one part cut out
   (``CUTS``: the products, the byte conversion, the pattern or h copies,
   the split kernel; their outputs are wrong by design and not checked) and
   variants (``VARIANTS``: the other route at B 8 to 64, other chunk and
   ring depths, no programmatic dependent launch), each built and timed in
   turns with the kernel in a CUDA graph, the patterns cold in L2; a
   variant must agree with the plain version.

Prints the card's name and power limit and one JSON line per measurement.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

FIRST = ROOT / "tools" / "first_designs" / "gam_coarse.cu"
V = 32000
SHAPES = [(8, 2048), (8, 512), (1, 2048), (16, 2048), (32, 2048), (64, 2048),
          (256, 2048)]
F32_FIRST_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int64,
                                              ctypes.c_void_p]

_MMA = [("          wgmma_bf16<NT>(acc[0], as[0], desc);\n"
         "          wgmma_bf16<NT>(acc[1], as[1], desc);",
         "          acc[0][0][0] += __uint_as_float((as[0][0] ^ as[0][3] ^ "
         "(uint32_t)desc) & 0x3fffffffu);\n          acc[1][0][0] += "
         "__uint_as_float((as[1][0] ^ as[1][3] ^ (uint32_t)(desc >> 32)) & "
         "0x3fffffffu);")]
for _src, _reg in (("b[0], b[1]", "b[0] ^ b[1]"),
                   ("b[2], b[3]", "b[2] ^ b[3]"),
                   ("l[0], l[1]", "l[0] ^ l[1]")):
    for _t in (0, 1):
        _MMA.append((f"          mma_bf16(acc[{_t}][n], as[{_t}], {_src});",
                     f"          acc[{_t}][n][0] += __uint_as_float((as[{_t}]"
                     f"[0] ^ as[{_t}][3] ^ {_reg}) & 0x3fffffffu);"))
CUTS = {
    # ALU ops that keep every fragment alive in place of the tensor cores
    "no_mma": _MMA,
    "no_convert": [(
        "  const uint32_t a = (x & 0x007f007fu) | 0x43004300u;",
        "  return x;\n  const uint32_t a = 0;")],
    "no_pattern_stage": [
        ("      if (VEC) tma_tile(", "      if (0) tma_tile("),
        ("mbar_expect(bar, (VEC ? C::PAT_BYTES : 0) + C::H_BYTES);",
         "mbar_expect(bar, C::H_BYTES);")],
    "no_h_stage": [
        ("      bulk_copy(smem_addr(", "      if (0) bulk_copy(smem_addr("),
        ("mbar_expect(bar, (VEC ? C::PAT_BYTES : 0) + C::H_BYTES);",
         "mbar_expect(bar, VEC ? C::PAT_BYTES : 0);")],
    "no_split_kernel": [("  split_h_kernel<<<", "  if (0) split_h_kernel<<<")],
}
# Variants: the other route at B <= 16, 32 and 64; other chunk and ring
# depths of the B <= 8 config; other chunks, pipelines and warpgroups at
# B 64; no overlap of the split kernel's launch with the main kernel's
# first copies.
_B8 = "X(0, 1, 1, 128, 3, false)"
_B16 = "X(1, 2, 1, 128, 3, false)"
_B32 = "X(2, 4, 1, 64, 4, true)"
_B64 = "X(3, 8, 1, 64, 3, true)"
VARIANTS = {
    "wgmma_b8": [(_B8, "X(0, 1, 1, 128, 3, true)")],
    "wgmma_b16": [(_B16, "X(1, 2, 1, 128, 3, true)")],
    "mma_b32": [(_B32, "X(2, 4, 1, 64, 4, false)")],
    "mma_b64": [(_B64, "X(3, 8, 1, 64, 3, false)")],
    "kd64": [(_B8, "X(0, 1, 1, 64, 3, false)")],
    "stages4": [(_B8, "X(0, 1, 1, 128, 4, false)")],
    "b64_kd128": [(_B64, "X(3, 8, 1, 128, 3, true)")],
    # B 64: two wgmma groups in flight (three A buffers); two warpgroups of
    # 32 rows; 32-row chunks in a 4-deep ring
    "wg_inflight2": [("    uint32_t a[2][2][4];", "    uint32_t a[3][2][4];"),
                     ("a[s & 1];", "a[s % 3];"),
                     ("        wgmma_wait<1>();", "        wgmma_wait<2>();")],
    "b64_two_groups": [(_B64, "X(3, 4, 2, 64, 3, true)")],
    "b64_kd32": [(_B64, "X(3, 8, 1, 32, 4, true)")],
    # the main kernel launched after the split kernel ends
    "no_pdl": [("attr[0].val.programmaticStreamSerializationAllowed = 1;",
                "attr[0].val.programmaticStreamSerializationAllowed = 0;")],
}
# The products of h's first two bf16 terms only (hi, mid), on both routes:
# the control that the third-term check must fail.
TWO_TERMS = [
    ("          mma_bf16(acc[0][n], as[0], l[0], l[1]);\n"
     "          mma_bf16(acc[1][n], as[1], l[0], l[1]);\n", ""),
    ("for (int x = 0; x < 3; ++x) {              // hi, mid, lo",
     "for (int x = 0; x < 2; ++x) {")]
# (B, d, V) of the third-term check: every config of the plan, both
# staging routes
PROBE_SHAPES = [(1, 2048, 4096), (8, 2048, 4096), (16, 512, 1001),
                (24, 2048, 4096), (64, 2048, 4096), (100, 512, 1001),
                (256, 2048, 4096)]
COUNT_BYTES = [
    ("namespace {\n", "__device__ unsigned long long gc_pattern_bytes;\n"
                      "namespace {\n"),
    ("  auto stage = [&](const Walk& w, int slot) {",
     "  unsigned long long staged = 0;\n"
     "  auto stage = [&](const Walk& w, int slot) {"),
    ("      if (VEC) tma_tile(smem_addr(ps), &tmap, tile * GC_TV, w.chunk * "
     "KD, bar);",
     "      if (VEC) tma_tile(smem_addr(ps), &tmap, tile * GC_TV, w.chunk * "
     "KD, bar);\n      staged += (unsigned long long)max(0, min(KD, D - "
     "w.chunk * KD)) * (unsigned long long)max((int64_t)0, min((int64_t)"
     "GC_TV, V - (int64_t)tile * GC_TV));"),
    ("    cw.next(n_passes, n_chunks);\n  }\n}\n",
     "    cw.next(n_passes, n_chunks);\n  }\n"
     "  atomicAdd(&gc_pattern_bytes, staged);\n}\n"),
]
COUNT_ENTRY = '''
extern "C" int gam_coarse_bytes(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long z = 0;
    return (int)cudaMemcpyToSymbol(gc_pattern_bytes, &z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, gc_pattern_bytes, sizeof(*out));
}
'''


def nvcc_cmd(src: Path, so: Path, *extra: str) -> list:
    from repro_torch.kernels import _build
    return [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I",
            str(_build.CSRC), "-o", str(so), str(src)]


def build(jobs: dict, tmp: str, extra=()) -> dict:
    """name -> (source text or path) compiled in parallel -> name -> CDLL
    (with ``extra`` flags: name -> nvcc's stderr instead)."""
    procs = {}
    for i, (name, src) in enumerate(jobs.items()):
        if isinstance(src, str):
            cu = Path(tmp) / f"job{i}.cu"
            cu.write_text(src)
            src = cu
        so = Path(tmp) / f"libjob{i}.so"
        procs[name] = (subprocess.Popen(nvcc_cmd(src, so, *extra),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       so)
    out = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name}:\n{err}")
        out[name] = err if extra else ctypes.CDLL(str(so))
    return out


def edited(cuts) -> str:
    from repro_torch.kernels import _build
    text = (_build.CSRC / "gam_coarse.cu").read_text()
    for old, new in cuts:
        if text.count(old) != 1:
            raise SystemExit(f"gam_coarse.cu does not hold "
                             f"{old.splitlines()[0]!r} once")
        text = text.replace(old, new)
    return text


def ptxas_report(tmp: str) -> None:
    from repro_torch.kernels import _build
    srcs = {"kernel": _build.CSRC / "gam_coarse.cu", "first_design": FIRST}
    errs = build(srcs, tmp, ("-Xptxas", "-v"))
    for tag, stderr in errs.items():
        kernel = None
        for line in stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            elif kernel and ("registers" in line or "spill" in line):
                print(f"ptxas {tag} {kernel}: "
                      f"{line.split(':', 1)[-1].strip()}")


class using:
    """Route the ``gam_coarse`` wrapper through ``lib`` inside the block."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from repro_torch.kernels import _build
        self.real = _build.library("gam_coarse")
        _build._loaded["gam_coarse"] = self.lib

    def __exit__(self, *exc):
        from repro_torch.kernels import _build
        _build._loaded["gam_coarse"] = self.real


def first_design(torch, lib, h, pat, inv):
    """The PR 14 kernel through its own entry point."""
    from repro_torch.kernels import _build
    b, d = h.shape
    v = pat.shape[1]
    out = torch.empty((b, v), dtype=torch.float32, device=h.device)
    _build.check(lib.gam_coarse_f32(
        h.data_ptr(), pat.data_ptr(), inv.data_ptr(), out.data_ptr(), b, d, v,
        torch.cuda.current_stream().cuda_stream), "first design")
    return out


def coarse_as_before(torch, h, pat, inv):
    """The wrapper as it was: the signature set and the device entered on
    every call, around today's kernel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import gam_coarse as gc
    b, d = h.shape
    v = pat.shape[1]
    plan = gc.coarse_plan(b, d, v, pat.data_ptr() % 16,
                          torch.cuda.get_device_properties(
                              h.device).multi_processor_count)
    out = torch.empty((b, v), dtype=torch.float32, device=h.device)
    scratch = torch.empty(plan.scratch, dtype=torch.bfloat16, device=h.device)
    fn = _build.library("gam_coarse").gam_coarse_f32
    fn.argtypes = gc._ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        _build.check(fn(h.data_ptr(), scratch.data_ptr(), pat.data_ptr(),
                        inv.data_ptr(), out.data_ptr(), b, d, v, plan.cfg,
                        int(plan.vec), plan.grid, stream), "gam_coarse")
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--against", type=Path, nargs="+", default=[],
                    help="other gam_coarse.cu builds, timed in turns")
    ap.add_argument("--ablate", action="store_true",
                    help="also time copies with parts cut out, and variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("coarse_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import gam_coarse as gc
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    ptxas_report(tmp)
    _build.build_all()
    jobs = {"first": FIRST, "count": edited(COUNT_BYTES) + COUNT_ENTRY,
            "two_terms": edited(TWO_TERMS)}
    if args.ablate:
        jobs.update({n: edited(c) for n, c in {**CUTS, **VARIANTS}.items()})
    others = [f"against:{f}" for f in args.against]
    jobs.update(zip(others, (f.resolve() for f in args.against)))
    libs = build(jobs, tmp)
    libs["first"].gam_coarse_f32.argtypes = F32_FIRST_ARGTYPES
    libs["first"].gam_coarse_f32.restype = ctypes.c_int
    occ = _build.library("gam_coarse").gam_coarse_occupancy
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for cfg in range(len(gc.CONFIGS)):
        n = ctypes.c_int(0)
        _build.check(occ(cfg, 1, ctypes.byref(n)), "occupancy")
        print(json.dumps({"row": "occupancy", "cfg": cfg,
                          "rows_per_pass": gc.CONFIGS[cfg][0],
                          "resident_ctas_per_sm": n.value,
                          "plan_ctas_per_sm": gc.coarse_plan(
                              gc.CONFIGS[cfg][0], 2048, V).ctas_per_sm}))

    gen = torch.Generator(dev).manual_seed(18)
    pats, inputs = {}, {}
    for b, d in SHAPES:
        if d not in pats:
            pats[d] = torch.randint(-1, 2, (d, V), device=dev, generator=gen,
                                    dtype=torch.int8)
        pat = pats[d]
        nnz = pat.abs().sum(dim=0).float()
        inputs[(b, d)] = (torch.randn((b, d), device=dev, generator=gen), pat,
                          1.0 / torch.sqrt(torch.clamp(nnz, min=1.0)))
    copies = {d: cs.cold_copies(torch, p) for d, p in pats.items()}

    def warm(fn):
        return cs.graph_ms(torch, fn)

    def cold(make, d):
        return cs.cold_graph_ms(torch, [lambda p=p: make(p) for p in
                                        copies[d]])

    for (b, d), (h, pat, inv) in inputs.items():
        label = f"B {b}, d {d}, V {V}"
        tol = gc.coarse_tolerance(h, pat, inv)
        want = gc.gam_coarse_plain(h, pat, inv)
        designs = {
            "kernel": lambda p, h=h, inv=inv: gc.gam_coarse(h, p, inv),
            "first_design": lambda p, h=h, inv=inv: first_design(
                torch, libs["first"], h, p, inv)}
        for name in others:
            def against(p, h=h, inv=inv, lib=libs[name]):
                with using(lib):
                    return gc.gam_coarse(h, p, inv)
            designs[name] = against
        checks = {}
        for name, fn in designs.items():
            got = fn(pat)
            torch.cuda.synchronize()
            if not bool(((got - want).abs() <= tol).all()):
                raise SystemExit(f"{name} {label}: beyond coarse_tolerance")
            checks[name] = float((got - want).abs().max())
        pf = pat.float()
        yard = lambda h=h, pf=pf, inv=inv: torch.mm(h, pf) * inv  # noqa: E731
        checks["yardstick"] = float((yard() - want).abs().max())
        n_bytes = b * d * 4 + d * V + V * 4 + b * V * 4
        t_bytes = n_bytes / cs.HBM_BYTES_PER_S * 1e3
        t_mma = 3 * 2.0 * b * d * V / cs.BF16_FLOPS * 1e3
        t_f32 = 2.0 * b * d * V / cs.F32_FLOPS * 1e3
        print(json.dumps({"row": label, "max_abs_err": checks,
                          "bound_ms_bytes": t_bytes,
                          "bound_ms_three_bf16_mma": t_mma,
                          "bound_ms_f32_fma": t_f32,
                          "plain_ms": cs.graph_ms(
                              torch, lambda h=h, pat=pat, inv=inv:
                              gc.gam_coarse_plain(h, pat, inv), 5, 5)}))
        order = (["first_design", "kernel"]
                 + [n for n in others for _ in (0, 1)]
                 + ["kernel", "first_design"])
        for rnd in range(args.rounds):
            for temp in ("warm", "cold"):
                res = {}
                for name in order:
                    fn = designs[name]
                    t = (warm(lambda fn=fn, pat=pat: fn(pat)) if temp == "warm"
                         else cold(fn, d))
                    res.setdefault(name, []).append(t)
                print(json.dumps({"row": label, "round": rnd, "l2": temp,
                                  "graph_ms": res}))
        ycop = [x.float() for x in copies[d][:max(2, -(-len(copies[d]) // 4))]]
        for rnd in range(args.rounds):
            print(json.dumps({
                "row": f"{label} yardstick (mm + scale, two calls)",
                "round": rnd, "warm_graph_ms": warm(yard),
                "cold_graph_ms": cs.cold_graph_ms(
                    torch, [lambda p=p, h=h, inv=inv: torch.mm(h, p) * inv
                            for p in ycop])}))
        del ycop

    # ---------------------------------------------------- pattern values
    h, pat, inv = inputs[(8, 2048)]
    r = torch.rand(pat.shape, device=dev, generator=gen)
    values = {"uniform ternary": pat,
              "13% nonzero": torch.where(r < 0.067, -1, torch.where(
                  r > 0.933, 1, 0)).to(torch.int8),
              "all zero": torch.zeros_like(pat)}
    del r
    for rnd in range(args.rounds):
        res = {}
        for name in list(values) + list(values)[::-1]:
            res.setdefault(name, []).append(warm(
                lambda p=values[name]: gc.gam_coarse(h, p, inv)))
        print(json.dumps({"row": "B 8, d 2048 by pattern values, warm graph",
                          "round": rnd, "graph_ms": res}))
    del values

    # ------------------------------------------------------- bytes read
    count = libs["count"].gam_coarse_bytes
    count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for b, d in ((64, 2048), (256, 2048), (8, 2048)):
        h, pat, inv = inputs[(b, d)]
        n = ctypes.c_ulonglong(0)
        _build.check(count(None, 1), "reset")
        with using(libs["count"]):
            gc.gam_coarse(h, pat, inv)
        torch.cuda.synchronize()
        _build.check(count(ctypes.byref(n), 0), "count")
        print(json.dumps({"row": f"pattern bytes staged, B {b}, d {d}",
                          "bytes": n.value, "d_times_V": d * V,
                          "ratio": n.value / (d * V)}))

    # ------------------------------------------------------------ the host
    h, pat, inv = inputs[(8, 2048)]
    for rnd in range(args.rounds):
        a = cs.time_ms(torch, lambda: coarse_as_before(torch, h, pat, inv), 50)
        b1 = cs.time_ms(torch, lambda: gc.gam_coarse(h, pat, inv), 50)
        b2 = cs.time_ms(torch, lambda: gc.gam_coarse(h, pat, inv), 50)
        a2 = cs.time_ms(torch, lambda: coarse_as_before(torch, h, pat, inv),
                        50)
        print(json.dumps({"row": "B 8, d 2048 eager, wrapper", "round": rnd,
                          "ms": [b1, b2], "wrapper_as_before_ms": [a, a2]}))

    # ------------------------------------------------- the third term of h
    for b, d, v in PROBE_SHAPES:
        h, pat, inv = gc.third_term_probe(b, d, v, seed=b + d, device=dev)
        row = {"row": f"third term, B {b}, d {d}, V {v}",
               "cfg": gc.coarse_plan(b, d, v).cfg}
        for name in ("kernel", "two_terms"):
            if name == "kernel":
                got = gc.gam_coarse(h, pat, inv)
            else:
                with using(libs[name]):
                    got = gc.gam_coarse(h, pat, inv)
            err, two = gc.third_term_errors(got, h, pat, inv)
            row[name] = {"max_abs_err": err, "ratio_to_two_terms": err / two}
        row["two_terms_exact_f64_max_abs_err"] = two
        print(json.dumps(row))
        if row["kernel"]["ratio_to_two_terms"] > 1 / 8:
            raise SystemExit(f"kernel {row['row']}: beyond an eighth of the "
                             "two-term error")
        if row["two_terms"]["ratio_to_two_terms"] <= 1 / 8:
            raise SystemExit(f"{row['row']}: the check passes a product of "
                             "two terms")

    # ------------------------------------------------------------ ablations
    if args.ablate:
        for name in VARIANTS:
            for key, (h, pat, inv) in inputs.items():
                with using(libs[name]):
                    got = gc.gam_coarse(h, pat, inv)
                torch.cuda.synchronize()
                if not bool(((got - gc.gam_coarse_plain(h, pat, inv)).abs()
                             <= gc.coarse_tolerance(h, pat, inv)).all()):
                    raise SystemExit(f"variant {name} {key}: beyond "
                                     "coarse_tolerance")
        for rnd in range(args.rounds):
            for key in ((8, 2048), (8, 512), (16, 2048), (32, 2048),
                        (64, 2048)):
                h, pat, inv = inputs[key]

                def fn(p, h=h, inv=inv):
                    return gc.gam_coarse(h, p, inv)
                out = {"row": f"B {key[0]}, d {key[1]} ablations, cold graph",
                       "round": rnd, "kernel": cold(fn, key[1])}
                for name in {**CUTS, **VARIANTS}:
                    with using(libs[name]):
                        out[name] = cold(fn, key[1])
                out["kernel_again"] = cold(fn, key[1])
                print(json.dumps(out))
    tmp_dir.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
