"""Perf hillclimbing driver: count named optimization variants of an
(arch, shape) pair and report the three roofline terms for each, so the
hypothesis -> change -> measure loop is fully scripted.

Counterpart of ``repro.launch.perf``: the same variants and records; each
variant's step is counted once at full depth on the abstract production
mesh (``launch.dryrun``), not compiled.

Variants (composable by '+'):
  baseline       the paper-faithful configuration as shipped
  attn_bf16      bf16 score/softmax tensors (attn_f32=False)
  truncate       causal KV truncation per q-chunk (attn_truncate=True)
  tp_only        no FSDP weight sharding (params TP-only; opt stays ZeRO)
  remat_dots     checkpoint_dots remat policy
  remat_none     no remat
  qchunk512/2048 blockwise attention chunk size
  cap10          MoE capacity factor 1.0 (from 1.25)
  ssm_rep        SSM projections and conv replicated
  gam_head       decode only: GAM-accelerated LM head (coarse int8 pattern
                 prefilter + candidate-budget exact scoring)
  mesh1          one card (a one-rank mesh) instead of the production mesh

Usage:
  PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen2-1.5b \\
      --shape prefill_32k --variants baseline,attn_bf16,attn_bf16+truncate
"""
import argparse
import json
import os

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import (Lowered, build_lowered, placed_cache,
                                       placed_params, placed_tokens)
from repro_torch.launch.mesh import (abstract_production_mesh, fake_mesh,
                                     mesh_axes)
from repro_torch.launch.roofline import costs, model_flops, terms
from repro_torch.launch.steps import (gam_head_inputs, make_gam_serve_step,
                                      shape_adapted_config)
from repro_torch.sharding.specs import NamedSharding, place

__all__ = ["apply_variant", "measure", "main"]


def apply_variant(cfg: ModelConfig, variant: str) -> tuple[ModelConfig, dict]:
    extra = {"gam_head": False, "mesh1": False}
    for tok in variant.split("+"):
        if tok == "baseline":
            continue
        elif tok == "attn_bf16":
            cfg = cfg.with_(attn_f32=False)
        elif tok == "truncate":
            cfg = cfg.with_(attn_truncate=True)
        elif tok == "tp_only":
            cfg = cfg.with_(fsdp=False)
        elif tok == "remat_dots":
            cfg = cfg.with_(remat="dots")
        elif tok == "remat_none":
            cfg = cfg.with_(remat="none")
        elif tok.startswith("qchunk"):
            cfg = cfg.with_(q_chunk=int(tok[len("qchunk"):]))
        elif tok == "cap10":
            cfg = cfg.with_(capacity_factor=1.0)
        elif tok == "ssm_rep":
            cfg = cfg.with_(spec_overrides=(
                (r"\['(in_proj|out_proj|conv_[wb])'\]", "replicate"),))
        elif tok == "gam_head":
            extra["gam_head"] = True
        elif tok == "mesh1":
            extra["mesh1"] = True
        else:
            raise ValueError(f"unknown variant token {tok!r}")
    return cfg, extra


def _over_model(mesh, shape: tuple, dim: int) -> NamedSharding:
    """Dim ``dim`` over the ``model`` axis where it divides, else
    replicated (as the spec functions sanitize)."""
    spec = [None] * len(shape)
    if shape[dim] % mesh_axes(mesh)["model"] == 0:
        spec[dim] = "model"
    return NamedSharding(mesh, tuple(spec))


def build_gam_lowered(cfg: ModelConfig, shape, mesh, *, coarse_k=128,
                      budget=16_384) -> Lowered:
    """serve_step with the GAM LM head (decode shapes only): the patterns
    and their scales sharded over ``model`` on the vocab."""
    cfg = shape_adapted_config(cfg, shape)
    model, params = placed_params(cfg, mesh)
    gam = gam_head_inputs(cfg)
    gam = {"patterns": place(gam["patterns"], _over_model(
               mesh, tuple(gam["patterns"].shape), 1)),
           "inv_sqrt_nnz": place(gam["inv_sqrt_nnz"], _over_model(
               mesh, tuple(gam["inv_sqrt_nnz"].shape), 0))}
    step = make_gam_serve_step(model, coarse_k=coarse_k, budget=budget)
    return Lowered(step, (params, gam, placed_cache(cfg, mesh, model, shape),
                          placed_tokens(cfg, mesh, shape.global_batch)))


def _probe(cfg, shape, mesh, *, gam_head=False):
    return costs(build_gam_lowered(cfg, shape, mesh) if gam_head
                 else build_lowered(cfg, shape, mesh))


def measure(arch: str, shape_name: str, variant: str, *,
            multi_pod: bool = False) -> dict:
    shape = SHAPES[shape_name]
    cfg, extra = apply_variant(get_config(arch), variant)
    if extra.pop("mesh1", False):
        # the paper's serving regime: single-card deployment
        mesh_cm = fake_mesh((1, 1), ("data", "model"))
        chips = 1
    else:
        mesh_cm = abstract_production_mesh(multi_pod=multi_pod)
        chips = 512 if multi_pod else 256
    with mesh_cm as mesh:
        c = _probe(cfg, shape, mesh, **extra)
    t = terms(c)
    mf = model_flops(cfg, shape)
    return {
        "arch": arch, "shape": shape_name, "variant": variant,
        "t_compute_s": t["compute"], "t_memory_s": t["memory"],
        "t_collective_s": t["collective"],
        "dominant": max(t, key=t.get),
        "useful_ratio": mf / max(c["flops"] * chips, 1.0),
        "chips": chips, "status": "ok",
        "peak_bytes_per_device": c["mem"]["peak"],
        "argument_bytes_per_device": c["mem"]["argument"],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=tuple(SHAPES), required=True)
    ap.add_argument("--variants", required=True)
    ap.add_argument("--out", default="results/torch/perf.json")
    args = ap.parse_args()
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for variant in args.variants.split(","):
        key = (args.arch, args.shape, variant)
        if any((r["arch"], r["shape"], r["variant"]) == key for r in results):
            print(f"-- cached {key}")
            continue
        rec = measure(args.arch, args.shape, variant)
        print(f"{args.arch} x {args.shape} [{variant}]: "
              f"compute={rec['t_compute_s']:.3e} "
              f"memory={rec['t_memory_s']:.3e} "
              f"coll={rec['t_collective_s']:.3e} dom={rec['dominant']} "
              f"useful={rec['useful_ratio']:.3f}")
        results.append(rec)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
