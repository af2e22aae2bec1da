#!/usr/bin/env python3
"""The port's bf16 attention kernels on one GPU, at the LM shapes of
``chip_smoke.py``: build facts, agreement with the plain versions, and
times against ``scaled_dot_product_attention`` over the decode kernel's
split sizing.

    python3 tools/attn_sweep.py [--ctas-per-sm 2 4 8] [--rounds 2]

1. Compiles ``flash_prefill.cu`` and ``decode_attention.cu`` with the
   port's ``nvcc`` flags and ``-Xptxas -v`` and prints each kernel's
   registers, spills and shared memory, and the count of ``HMMA``
   instructions ``cuobjdump -sass`` finds in each (where the toolkit has
   ``cuobjdump``).
2. At tinyllama-1.1b's prefill (B 8, S 1,024, Hkv 4, G 8, hd 64) and at its
   decode shapes (B 8, S 1,064, length 1,054, in a CUDA graph; B 128, S
   32,768, ``decode_32k``), random bf16 inputs from a seed: each kernel is
   held to its plain version (one bf16 step: rtol 2^-7, atol 1e-5), then
   timed in turns with SDPA, ``--rounds`` times; ``decode_attention`` once
   for each ``--ctas-per-sm`` (the CTAs per SM its splits aim at).
3. With ``--ablate``: copies of ``flash_prefill.cu`` with parts of the bf16
   kernel's work cut out (``ABLATIONS``: the q.k products, the p.v
   products, both, and both with the exponentials), each built and timed in
   turns with the kernel at tinyllama's prefill, to show what its time is
   made of.  Their outputs are wrong by design and are not checked.

Prints the card's name and power limit and one JSON line per measurement.
"""
from __future__ import annotations

import argparse
import importlib
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


# Cuts from the bf16 prefill kernel: (text of flash_prefill.cu, stand-in).
# The stand-ins keep the operands live (an xor into an accumulator), so the
# loads and the rest of the tile's work stay.
_NO_QK = [("        attn::mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);\n"
           "        attn::mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);",
           "        s[2 * np][0] += __uint_as_float((qf[kk][0] ^ qf[kk][1] ^ "
           "kf[0] ^ kf[1]) & 0x3fffffffu);\n"
           "        s[2 * np + 1][0] += __uint_as_float((qf[kk][2] ^ "
           "qf[kk][3] ^ kf[2] ^ kf[3]) & 0x3fffffffu);")]
_NO_PV = [("        attn::pv_mma(o[2 * np], o[2 * np + 1], ph, pm, pl, vf);",
           "        o[2 * np][0] += __uint_as_float((ph[0] ^ pm[1] ^ pl[2] ^ "
           "ph[3] ^ vf[0] ^ vf[1]) & 0x3fffffffu);\n"
           "        o[2 * np + 1][0] += __uint_as_float((pm[0] ^ pl[1] ^ "
           "ph[2] ^ pm[3] ^ pl[3] ^ pm[2] ^ ph[1] ^ pl[0] ^ vf[2] ^ vf[3]) & "
           "0x3fffffffu);")]
_NO_EXP = [("attn::ex2(", "(")]
ABLATIONS = {"no_qk": _NO_QK, "no_pv": _NO_PV, "no_mma": _NO_QK + _NO_PV,
             "no_mma_no_exp": _NO_QK + _NO_PV + _NO_EXP}


def _nvcc(src: Path, so: Path, *extra: str) -> str:
    """Compile ``src`` as the port builds its kernels; -> nvcc's stderr."""
    from repro_torch.kernels import _build
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-I",
                          str(_build.CSRC), "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc {src.name}:\n{res.stderr}")
    return res.stderr


def ablated_prefill(torch, cs, rounds: int) -> None:
    """Time ``ABLATIONS`` against the kernel at tinyllama's prefill."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_prefill as fp
    src = (_build.CSRC / "flash_prefill.cu").read_text()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    q, k, v = (torch.randn(sh, device=dev, generator=gen).to(torch.bfloat16)
               for sh in ((8, 1024, 4, 8, 64), (8, 1024, 4, 64),
                          (8, 1024, 4, 64)))
    b, s, hkv, g, hd = q.shape
    runs = {"kernel": lambda: fp.flash_prefill(q, k, v)}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for name, cuts in ABLATIONS.items():
            text = src
            for old, new in cuts:
                if old not in text:
                    raise SystemExit(f"ablation {name}: flash_prefill.cu no "
                                     f"longer holds {old.splitlines()[0]!r}")
                text = text.replace(old, new)
            cu = Path(tmp) / f"{name}.cu"
            cu.write_text(text)
            _nvcc(cu, Path(tmp) / f"lib{name}.so")
            libs[name] = ctypes.CDLL(str(Path(tmp) / f"lib{name}.so"))
        out = torch.empty_like(q)
        for name, lib in libs.items():
            fn = lib.flash_prefill_bf16
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def run(fn=fn):
                stream = torch.cuda.current_stream().cuda_stream
                _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), b, s, hkv, g, hd,
                                fp.query_tile(g), hd ** -0.5, stream), "run")
            runs[name] = run
        for r in range(rounds):
            print(json.dumps({"row": "flash_prefill ablations", "round": r,
                              **{n: cs.time_ms(torch, fn, 20)
                                 for n, fn in runs.items()}}))


def ptxas_report() -> None:
    from repro_torch.kernels import _build
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("flash_prefill", "decode_attention"):
            so = Path(tmp) / f"lib{name}.so"
            stderr = _nvcc(_build.CSRC / f"{name}.cu", so, "-Xptxas", "-v")
            kernel = None
            for line in stderr.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    kernel = m.group(1)
                elif kernel and ("registers" in line or "spill" in line):
                    print(f"ptxas {name} {kernel}: {line.split(':', 1)[-1]}"
                          .strip())
            dump = Path(_build._nvcc()).with_name("cuobjdump")
            if not dump.exists():
                print(f"sass {name}: cuobjdump not in the toolkit")
                continue
            sass = subprocess.run([str(dump), "-sass", str(so)],
                                  capture_output=True, text=True).stdout
            fn = None
            counts: dict[str, int] = {}
            for line in sass.splitlines():
                m = re.search(r"Function : (\w+)", line)
                if m:
                    fn = m.group(1)
                elif fn and "HMMA" in line:
                    counts[fn] = counts.get(fn, 0) + 1
            print(f"sass {name}: HMMA instructions by kernel "
                  f"{json.dumps(counts)}")


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ctas-per-sm", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ablate", action="store_true",
                    help="also time the prefill kernel with parts cut out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    from repro_torch.kernels import flash_prefill as fp
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    ptxas_report()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    bf = torch.bfloat16
    rtol, atol = cs.prefill_tol(bf)

    def check(name, got, want):
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.isclose(got.float(), want.float(), rtol=rtol,
                                atol=atol).all())
        print(json.dumps({"check": name, "ok": ok, "max_abs_err": err,
                          "mean_abs_out": float(want.float().abs().mean())}))
        if not ok:
            raise SystemExit(f"{name} differs from its plain version")

    import torch.nn.functional as F
    q, k, v = (torch.randn(sh, device=dev, generator=gen).to(bf)
               for sh in ((8, 1024, 4, 8, 64), (8, 1024, 4, 64),
                          (8, 1024, 4, 64)))
    check("flash_prefill", fp.flash_prefill(q, k, v),
          fp.flash_prefill_plain(q, k, v))
    qs = q.reshape(8, 1024, 32, 64).transpose(1, 2)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    for r in range(args.rounds):
        print(json.dumps({
            "row": "flash_prefill", "round": r,
            "ms": cs.time_ms(torch, lambda: fp.flash_prefill(q, k, v), 20),
            "sdpa_ms": cs.time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True), 20)}))
    del q, k, v, qs, ks, vs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, b, s, length, graphed in (
            ("decode_attention", 8, 1064, 1054, True),
            ("decode_attention@decode_32k", 128, 32768, 32767, False)):
        q = torch.randn((b, 4, 8, 64), device=dev, generator=gen).to(bf)
        k = torch.randn((b, s, 4, 64), device=dev, generator=gen).to(bf)
        v = torch.randn((b, s, 4, 64), device=dev, generator=gen).to(bf)
        n = torch.tensor(length, dtype=torch.int32, device=dev)
        want = da.decode_attention_plain(q, k, v, n)
        sdpa = cs.sdpa_call(torch, q, k, v, n)

        def timed(fn):
            return (cs.graph_ms(torch, fn) if graphed
                    else cs.time_ms(torch, fn, 10))
        default = da._MMA_CTAS_PER_SM
        for c in args.ctas_per_sm:
            da._MMA_CTAS_PER_SM = c
            check(f"{name} ctas_per_sm {c}", da.decode_attention(q, k, v, n),
                  want)
            grid = da.decode_splits(b, 4, 8, 64, s, sms, 2)
            for r in range(args.rounds):
                print(json.dumps({
                    "row": name, "ctas_per_sm": c, "splits": grid[-1],
                    "chunk": grid[-2], "round": r,
                    "ms": timed(lambda: da.decode_attention(q, k, v, n)),
                    "sdpa_ms": timed(sdpa)}))
        da._MMA_CTAS_PER_SM = default
        del q, k, v, want
        torch.cuda.empty_cache()
    if args.ablate:
        ablated_prefill(torch, cs, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
