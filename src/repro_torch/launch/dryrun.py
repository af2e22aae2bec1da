"""Multi-pod dry-run: place every (arch x input-shape) step on the production
mesh and count its per-device work, memory and collectives into a JSON
ledger.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each step with XLA on 512 forced host devices and reads the compiler's
cost and memory analyses.  The port has no compiler: it places meta
parameters, optimizer state and batch or cache as DTensors on
``launch.mesh.abstract_production_mesh`` (a fake group of 256 or 512
ranks, this process rank 0) and runs the eager step once under a
``launch.cost.CostCounter``, which counts rank 0's local program.  Nothing
is allocated and no device is needed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out FILE]

A record's keys are the reference's (``bytes_per_device`` {argument,
output, temp, peak}, ``flops_per_device``, ``hbm_bytes_per_device``,
``collectives_per_device``, ``status``, ``lower_s``: the seconds to place
and count; nothing compiles, so there is no ``compile_s``), plus the flops
by unit, the kernel entries' share, and the mesh's device type.  The train
step donates nothing: its peak holds the old parameters and moments beside
the new ones.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.cost import (CostCounter, collective_bytes,
                                     cost_analysis_dict)
from repro_torch.launch.mesh import abstract_production_mesh
from repro_torch.launch.steps import (abstract_cache, abstract_opt_state,
                                      abstract_params, input_specs,
                                      make_prefill_step, make_serve_step,
                                      make_train_step, shape_adapted_config)
from repro_torch.models.model import Model
from repro_torch.sharding.specs import (NamedSharding, batch_specs,
                                        cache_specs, param_shardings, place)
from repro_torch.training.optimizer import AdamWState

__all__ = ["SKIPS", "Lowered", "build_lowered", "run_one", "main",
           "cost_analysis_dict", "collective_bytes"]

SKIPS = {
    # (arch, shape) combinations that are out of family scope (DESIGN.md §4)
    ("whisper-tiny", "long_500k"):
        "enc-dec: a 524288-token text decode is outside the family's scope",
}


@dataclasses.dataclass
class Lowered:
    """A step and its placed inputs, ready to count (the counterpart of
    jax's ``Lowered``: :meth:`count` takes the place of ``compile``)."""
    fn: object
    args: tuple

    def count(self) -> CostCounter:
        """Run the step once under a fresh counter, its inputs marked as
        arguments and its result as output."""
        counter = CostCounter()
        counter.arguments(*self.args)
        with counter:
            out = self.fn(*self.args)
        counter.outputs(out)
        return counter


def placed_opt_state(mesh, model):
    """The AdamW state of ``model``'s params placed as the reference's
    ``in_shardings`` place it: the moments ZeRO-sharded (``fsdp=True``)
    whatever the params' rule, the step replicated."""
    opt = abstract_opt_state(abstract_params(model))
    return AdamWState(
        step=place(opt.step, NamedSharding(mesh, ())),
        mu=place(opt.mu, param_shardings(mesh, opt.mu, fsdp=True)),
        nu=place(opt.nu, param_shardings(mesh, opt.nu, fsdp=True)))


def placed_params(cfg: ModelConfig, mesh):
    """(model on meta, its params placed by ``param_shardings``)."""
    model = Model(cfg, device="meta")
    params = abstract_params(model)
    return model, place(params, param_shardings(
        mesh, params, fsdp=cfg.fsdp, overrides=cfg.spec_overrides))


def placed_tokens(cfg: ModelConfig, mesh, batch: int):
    """A decode step's (batch, 1) int32 tokens, placed by
    ``batch_specs``."""
    tok = torch.empty((batch, 1), dtype=torch.int32, device="meta")
    return place(tok, batch_specs(cfg, mesh, tok))


def placed_cache(cfg: ModelConfig, mesh, model, shape: ShapeConfig):
    """The decode cache of ``seq_len`` positions, placed by
    ``cache_specs`` (the sequence sharded when batch is 1)."""
    cache = abstract_cache(model, shape.global_batch, shape.seq_len)
    return place(cache, cache_specs(cfg, mesh, cache,
                                    seq_shard=shape.global_batch == 1))


def build_lowered(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Lowered:
    """Place the step for (cfg, shape) on ``mesh``: meta params, the AdamW
    state and the batch (train), the batch (prefill), or the cache and one
    token a sequence (decode)."""
    cfg = shape_adapted_config(cfg, shape)
    model, params = placed_params(cfg, mesh)
    if shape.kind == "decode":
        # decode: ONE new token against a cache of seq_len
        return Lowered(make_serve_step(model), (
            params, placed_cache(cfg, mesh, model, shape),
            placed_tokens(cfg, mesh, shape.global_batch)))
    batch = input_specs(cfg, shape)
    batch = place(batch, batch_specs(cfg, mesh, batch))
    if shape.kind == "train":
        return Lowered(make_train_step(model),
                       (params, placed_opt_state(mesh, model), batch))
    return Lowered(make_prefill_step(model, capacity=shape.seq_len),
                   (params, batch))


def describe(counter: CostCounter) -> dict:
    """A counted step in the record's keys."""
    cost = cost_analysis_dict(counter)
    return {"bytes_per_device": counter.memory(),
            "flops_per_device": cost["flops"],
            "flops_per_device_by_unit": cost["flops by unit"],
            "hbm_bytes_per_device": cost["bytes accessed"],
            "collectives_per_device": collective_bytes(counter),
            "kernels_per_device": counter.record()["kernels"],
            "aten_ops": counter.ops}


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            cfg_override=None, verbose: bool = True) -> dict:
    shape = SHAPES[shape_name]
    cfg = cfg_override or get_config(arch)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "chips": 512 if multi_pod else 256, "mesh_device_type": "cpu"}
    if (arch, shape_name) in SKIPS:
        rec["status"] = "skip"
        rec["reason"] = SKIPS[(arch, shape_name)]
        return rec
    t0 = time.monotonic()
    with abstract_production_mesh(multi_pod=multi_pod) as mesh:
        counter = build_lowered(cfg, shape, mesh).count()
    rec["lower_s"] = round(time.monotonic() - t0, 1)
    rec.update(describe(counter))
    rec["donated"] = False
    rec["status"] = "ok"
    if verbose:
        print(f"== {arch} x {shape_name} on {rec['mesh']} "
              f"({rec['mesh_device_type']}-typed fake group; placed and "
              f"counted in {rec['lower_s']}s)")
        print("memory (bytes/device; nothing donated):",
              rec["bytes_per_device"])
        print("cost: flops/device={:.3e} {} bytes/device={:.3e}".format(
            rec["flops_per_device"], rec["flops_per_device_by_unit"],
            rec["hbm_bytes_per_device"]))
        print("collectives/device:", rec["collectives_per_device"])
        if rec["kernels_per_device"]:
            print("kernel entries/device:", rec["kernels_per_device"])
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/torch/dryrun.json")
    args = ap.parse_args()
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    pairs = ([(args.arch, args.shape)] if not args.all else
             [(a, s) for a in ARCH_IDS for s in SHAPES])
    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") in ("ok", "skip")}
    for arch, shape in pairs:
        mesh_name = "2x16x16" if args.multi_pod else "16x16"
        if (arch, shape, mesh_name) in done:
            print(f"-- cached: {arch} x {shape} on {mesh_name}")
            continue
        try:
            rec = run_one(arch, shape, multi_pod=args.multi_pod)
        except Exception as e:  # a failure here is a bug in the system
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "status": "FAIL", "error": f"{type(e).__name__}: {e}"}
        results = [r for r in results
                   if not (r["arch"] == arch and r["shape"] == shape
                           and r["mesh"] == mesh_name)]
        results.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    bad = [r for r in results if r.get("status") == "FAIL"]
    print(f"\n{len([r for r in results if r.get('status') == 'ok'])} ok, "
          f"{len([r for r in results if r.get('status') == 'skip'])} skip, "
          f"{len(bad)} FAIL")
    for r in bad:
        print("FAIL:", r["arch"], r["shape"], r["mesh"], r.get("error"))
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
