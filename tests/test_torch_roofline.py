"""The port's roofline and perf probe (``launch/{roofline,perf}.py``) against
the JAX reference.

* ``model_flops`` equals the reference's for every arch x shape (1e-12
  relative); ``_probe_layers`` and ``_with_layers`` equal the reference's
  field by field.
* ``apply_variant`` gives the reference's config and ``extra`` for every
  token, for ``attn_bf16+truncate`` and ``gam_head+mesh1``, and raises on
  an unknown token as the reference does.
* The count is affine in depth: at L layers it equals the extrapolation
  from ``_probe_layers``' L1 and L2 (the reference's fit), for a reduced
  dense model's train and decode steps.
* The roofline terms use the H100's own rates, each unit at its own.
* ``roofline_for`` and ``measure`` give the reference's record keys.

Every test leaves no process group behind (the fixture checks).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch import perf as jperf  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          get_reduced_config)
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import perf, roofline  # noqa: E402
from repro_torch.launch.dryrun import Lowered  # noqa: E402
from repro_torch.launch.steps import make_serve_step, make_train_step  # noqa: E402,E501
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import adamw_init  # noqa: E402

TOKENS = ["baseline", "attn_bf16", "truncate", "tp_only", "remat_dots",
          "remat_none", "qchunk512", "qchunk2048", "cap10", "ssm_rep",
          "gam_head", "mesh1", "attn_bf16+truncate", "gam_head+mesh1"]


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a test left a process group behind"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    for shape in SHAPES:
        want = jroofline.model_flops(jget_config(arch), JSHAPES[shape])
        got = roofline.model_flops(get_config(arch), SHAPES[shape])
        assert abs(got - want) <= 1e-12 * abs(want) and want > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_probe_configs_equal_reference(arch):
    jc, tc = jget_config(arch), get_config(arch)
    assert roofline._probe_layers(tc) == jroofline._probe_layers(jc)
    for n in roofline._probe_layers(tc):
        assert (dataclasses.asdict(roofline._with_layers(tc, n))
                == dataclasses.asdict(jroofline._with_layers(jc, n)))


@pytest.mark.parametrize("variant", TOKENS)
def test_apply_variant_equals_reference(variant):
    for arch in ("tinyllama-1.1b", "mamba2-780m"):
        jc, jx = jperf.apply_variant(jget_config(arch), variant)
        tc, tx = perf.apply_variant(get_config(arch), variant)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tx == jx


def test_apply_variant_raises_on_an_unknown_token():
    for mod, cfg in ((perf, get_config("tinyllama-1.1b")),
                     (jperf, jget_config("tinyllama-1.1b"))):
        with pytest.raises(ValueError, match="unknown variant token"):
            mod.apply_variant(cfg, "baseline+warp9")


def _count(cfg, kind: str) -> dict:
    model = Model(cfg, device="meta")
    params = model.init(0)
    tok = torch.empty((2, 33), dtype=torch.int32, device="meta")
    if kind == "train":
        args = (params, adamw_init(params), {"tokens": tok})
        return Lowered(make_train_step(model), args).count().record()
    args = (params, model.init_cache(2, 40), tok[:, :1])
    return Lowered(make_serve_step(model), args).count().record()


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_count_is_affine_in_depth(kind):
    """cost(L) = cost(L1) + (L - L1) / (L2 - L1) * (cost(L2) - cost(L1)),
    the reference's extrapolation, holds for the eager count exactly."""
    cfg = get_reduced_config("tinyllama-1.1b").with_(vocab=256, n_layers=5,
                                                     use_decode_kernel=True)
    l1, l2 = roofline._probe_layers(cfg)
    c1, c2, full = (_count(roofline._with_layers(cfg, n), kind)
                    for n in (l1, l2, cfg.n_layers))
    scale = (cfg.n_layers - l1) / (l2 - l1)
    for unit in full["flops"]:
        a, b = c1["flops"][unit], c2["flops"][unit]
        assert full["flops"][unit] == a + scale * (b - a)
    a, b = c1["bytes_accessed"], c2["bytes_accessed"]
    assert full["bytes_accessed"] == a + scale * (b - a)
    assert c2["bytes_accessed"] > c1["bytes_accessed"]


def test_terms_use_each_units_rate():
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.PEAK_FLOPS_BY_UNIT == {"bf16": 989e12, "f32": 67e12,
                                           "int8": 1979e12}
    assert roofline.NET_BW == 50e9 and roofline.NVLINK_BW == 450e9
    t = roofline.compute_seconds({"bf16": 989e12, "f32": 67e12,
                                  "int8": 1979e12, "float64": 67e12})
    assert t == pytest.approx(4.0)


def test_roofline_and_perf_records_keep_the_reference_keys():
    cfg = get_reduced_config("tinyllama-1.1b").with_(vocab=512)
    rec = roofline.roofline_for("tinyllama-1.1b", "decode_32k",
                                cfg_override=cfg)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert {"flops_global", "bytes_global", "coll_global",
            "coll_by_kind_body", "t_compute_s", "t_memory_s",
            "t_collective_s", "dominant", "model_flops", "useful_ratio",
            "mem_per_device"} <= set(rec)
    assert rec["dominant"] in ("compute", "memory", "collective")
    skip = roofline.roofline_for("whisper-tiny", "long_500k")
    assert skip["status"] == "skip"
    p = perf.measure("whisper-tiny", "decode_32k", "baseline+mesh1")
    assert p["chips"] == 1 and p["t_collective_s"] == 0.0
    assert {"arch", "shape", "variant", "t_compute_s", "t_memory_s",
            "t_collective_s", "dominant", "useful_ratio"} <= set(p)


def test_remat_tokens_change_what_is_counted(monkeypatch):
    """``remat_none`` and ``remat_dots`` count other programs than
    ``baseline`` (the published ``remat="full"``): on a reduced tinyllama
    with the published remat, at ``train_4k`` on one rank, ``full``
    recomputes each block's forward (more flops and bytes, a lower
    usefulness ratio: the reference's remat waste) and holds the lowest
    peak; ``dots`` recomputes no product (``none``'s flops) and lies
    between the two in bytes and peak."""
    cfg = get_reduced_config("tinyllama-1.1b").with_(vocab=512, q_chunk=1024)
    monkeypatch.setattr(perf, "get_config",
                        lambda arch: cfg.with_(remat="full"))
    rec = {v: perf.measure("tinyllama-1.1b", "train_4k", f"{v}+mesh1")
           for v in ("baseline", "remat_none", "remat_dots")}
    full, none, dots = rec["baseline"], rec["remat_none"], rec["remat_dots"]
    assert full["t_compute_s"] > none["t_compute_s"] == dots["t_compute_s"]
    assert full["t_memory_s"] > dots["t_memory_s"] > none["t_memory_s"]
    assert (full["peak_bytes_per_device"] < dots["peak_bytes_per_device"]
            < none["peak_bytes_per_device"])
    assert full["useful_ratio"] < none["useful_ratio"] == dots["useful_ratio"]
    assert full["argument_bytes_per_device"] \
        == none["argument_bytes_per_device"]
