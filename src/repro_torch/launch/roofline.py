"""Roofline analysis from the counted dry-run steps (H100 target).

Counterpart of ``repro.launch.roofline``.  Terms (per arch x shape x mesh),
all derived WITHOUT hardware, per card:
  compute    = sum over units of flops_unit / PEAK_FLOPS_BY_UNIT[unit]
  memory     = bytes accessed / HBM_BW
  collective = collective bytes / NET_BW

The reference compiles each pair three times, because XLA counts a scan
body once: at the true layer count L and unrolled at probe counts L1 < L2,
then extrapolates.  The port's counter runs the eager step, which runs
every layer, so the full depth is counted once.  ``_probe_layers`` and
``_with_layers`` stay as the reference has them: the tests use them to
check that the count is affine in depth.

MODEL_FLOPS = 6 * N(active) * D tokens (train; 2ND for single-token decode
per sequence): the usefulness ratio MODEL_FLOPS / counted flops catches
recomputation and redundancy.
"""
import argparse
import json
import os

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import SKIPS, build_lowered
from repro_torch.launch.mesh import abstract_production_mesh

# NVIDIA H100 SXM5 80GB data sheet, at its 700 W power limit (dense rates)
PEAK_FLOPS = 989e12      # bf16 / f16 tensor cores, FLOP/s a card
PEAK_FLOPS_BY_UNIT = {
    "bf16": PEAK_FLOPS,
    "f32": 67e12,        # f32 outside the tensor cores (TF32 stays off)
    "int8": 1979e12,     # int8 tensor cores, OP/s
}
HBM_BW = 3.35e12         # HBM3, B/s a card
# collectives across nodes: one 400 Gb/s NDR InfiniBand port a card (an
# H100 SXM5 node's usual fabric); a 16-wide mesh axis spans two 8-card
# NVLink nodes, so its collectives cross the network
NET_BW = 50e9            # B/s a card
NVLINK_BW = 450e9        # NVLink 4 within a node, B/s a card each way

__all__ = ["roofline_for", "model_flops", "compute_seconds", "costs",
           "terms", "main",
           "PEAK_FLOPS", "PEAK_FLOPS_BY_UNIT", "HBM_BW", "NET_BW",
           "NVLINK_BW"]


def _probe_layers(cfg: ModelConfig) -> tuple[int, int]:
    if cfg.family == "hybrid":
        return 3, 6          # one and two period-3 groups
    if cfg.family == "encdec":
        return 1, 2
    return 1, 2


def _with_layers(cfg: ModelConfig, n: int) -> ModelConfig:
    """Probe config: n layers, UNROLLED, as the reference's (there: because
    XLA counts a scan body once; here the eager step runs every layer
    either way)."""
    kw = {"n_layers": n, "scan_layers": False}
    if cfg.family == "encdec":
        kw["n_encoder_layers"] = n
    return cfg.with_(**kw)


def compute_seconds(flops_by_unit: dict) -> float:
    """Each unit's operations at its own peak rate (a unit without one,
    such as f64, at the f32 rate)."""
    return sum(f / PEAK_FLOPS_BY_UNIT.get(u, PEAK_FLOPS_BY_UNIT["f32"])
               for u, f in flops_by_unit.items())


def costs(lowered) -> dict:
    """Count a placed step (``dryrun.Lowered``) once: its flops (all and
    by unit), bytes, collective bytes (all and by kind) and memory."""
    counter = lowered.count()
    return {
        "flops": sum(counter.flops.values()),
        "flops_by_unit": dict(counter.flops),
        "bytes": counter.bytes_accessed,
        "coll": sum(counter.collectives.values()),
        "coll_by_kind": dict(counter.collectives),
        "mem": counter.memory(),
    }


def model_flops(cfg: ModelConfig, shape) -> float:
    """Analytic useful FLOPs (global): 6*N_active*D train, 2*N_active*B decode."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token/sequence


def terms(cost: dict) -> dict:
    """The three roofline terms (s) of one card's counted step."""
    return {"compute": compute_seconds(cost["flops_by_unit"]),
            "memory": cost["bytes"] / HBM_BW,
            "collective": cost["coll"] / NET_BW}


def roofline_for(arch: str, shape_name: str, *, multi_pod: bool = False,
                 cfg_override=None) -> dict:
    if (arch, shape_name) in SKIPS:
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": SKIPS[(arch, shape_name)]}
    cfg = cfg_override or get_config(arch)
    chips = 512 if multi_pod else 256
    shape = SHAPES[shape_name]
    with abstract_production_mesh(multi_pod=multi_pod) as mesh:
        full = costs(build_lowered(cfg, shape, mesh))
    t = terms(full)
    dominant = max(t, key=t.get)
    flops_global = full["flops"] * chips
    mf = model_flops(cfg, shape)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "status": "ok",
        "flops_global": flops_global,
        "flops_global_by_unit": {u: f * chips
                                 for u, f in full["flops_by_unit"].items()},
        "bytes_global": full["bytes"] * chips,
        "coll_global": full["coll"] * chips,
        "coll_by_kind_body": full["coll_by_kind"],
        "t_compute_s": t["compute"],
        "t_memory_s": t["memory"],
        "t_collective_s": t["collective"],
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": mf / max(flops_global, 1.0),
        "mem_per_device": {k: full["mem"][k]
                           for k in ("argument", "temp", "peak")},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/torch/roofline.json")
    args = ap.parse_args()
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    pairs = ([(args.arch, args.shape)] if not args.all else
             [(a, s) for a in ARCH_IDS for s in SHAPES])
    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"]) for r in results
            if r.get("status") in ("ok", "skip")}
    failed = False
    for arch, shape in pairs:
        if (arch, shape) in done:
            print(f"-- cached {arch} x {shape}")
            continue
        try:
            rec = roofline_for(arch, shape, multi_pod=args.multi_pod)
        except Exception as e:  # a failure here is a bug in the system
            import traceback
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "status": "FAIL",
                   "error": str(e)}
            failed = True
        if rec.get("status") == "ok":
            print(f"{arch:18s} {shape:12s} compute={rec['t_compute_s']:.3e}s "
                  f"memory={rec['t_memory_s']:.3e}s "
                  f"coll={rec['t_collective_s']:.3e}s "
                  f"dom={rec['dominant']:10s} "
                  f"useful={rec['useful_ratio']:.2f}")
        else:
            print(f"{arch} {shape}: {rec['status']}")
        results = [r for r in results
                   if not (r["arch"] == arch and r["shape"] == shape)]
        results.append(rec)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
