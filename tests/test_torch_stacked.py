"""The port's ``build_stacked`` against the JAX package's, leaf by leaf
(float64): index plans and static metadata exactly, float tables to 1e-12;
and ``from_numpy`` carrying a JAX-stacked problem across."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import raocp_tpu.models as jax_models  # noqa: E402
from raocp_tpu.core.stacked import build_stacked as jax_build  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
from raocp_tpu_torch.core.stacked import (build_stacked, from_numpy,  # noqa
                                          to_numpy)

FIXTURES = [
    ("demo", "demo_problem", {}, 1),
    ("demo_pad4", "demo_problem", {}, 4),
    ("ragged_dense", "demo_problem", dict(num_stages=4, stopping_time=4), 1),
    ("lqr", "lqr_binary_problem", {}, 1),
    ("mass_spring", "mass_spring_problem", dict(num_stages=4), 1),
    ("mass_spring_chain", "mass_spring_problem",
     dict(num_stages=5, stopping_time=2), 1),
    ("random_network", "random_network_problem",
     dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
          stopping_time=4), 1),
    ("random_network_pad4", "random_network_problem",
     dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
          stopping_time=4), 4),
    ("soc_network", "soc_network_problem",
     dict(num_states=4, num_inputs=2, num_modes=2, num_stages=4,
          stopping_time=2), 1),
]


def _pair(family, kwargs, pad, **build):
    port_spec, _ = getattr(port_models, family)(**kwargs)
    jax_spec, _ = getattr(jax_models, family)(**kwargs)
    port = build_stacked(port_spec, dtype=torch.float64, pad_multiple=pad,
                         device="cpu", **build)
    ref = jax_build(jax_spec, dtype=jnp.float64, pad_multiple=pad, **build)
    return port, ref


def _assert_leaf_equal(name, got, want):
    if want is None:
        assert got is None, name
        return
    assert got is not None, name
    if isinstance(want, tuple):
        assert len(got) == len(want), name
        for k, (g, w) in enumerate(zip(got, want)):
            _assert_leaf_equal(f"{name}[{k}]", g, w)
        return
    if isinstance(want, dict):
        for k in want:
            _assert_leaf_equal(f"{name}.{k}", got[k], want[k])
        return
    assert got.shape == want.shape, name
    if want.dtype.kind in "biu":
        assert got.dtype.kind == want.dtype.kind, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   err_msg=name)


def assert_same_problem(port_sp, jax_sp):
    got, got_static = to_numpy(port_sp)
    want, want_static = to_numpy(jax_sp)
    for name, v in want_static.items():
        if name in got_static:
            assert got_static[name] == v, name
        else:                       # multi-device fields: unset in JAX too
            assert v is None and got.get(name) is None, name
    for name, v in want.items():
        if name in ("node_mask", "lf_half_mask") or name not in got:
            assert v is None, name
        _assert_leaf_equal(name, got.get(name), v)


@pytest.mark.parametrize("fixture", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_build_stacked_matches_jax(fixture):
    _, family, kwargs, pad = fixture
    port, ref = _pair(family, kwargs, pad)
    assert port.dtype == torch.float64 and port.device.type == "cpu"
    assert port.anc.dtype == torch.int64
    assert port.risk_free_rows.dtype == torch.bool
    assert_same_problem(port, ref)
    if pad > 1:
        # ghost rows: zero tables, +-inf bounds
        NL = port.num_nonleaf
        assert torch.all(port.b_pad[NL:] == 0)
        assert torch.all(port.nl_lo[NL:] == -np.inf)
        assert torch.all(port.nl_hi[NL:] == np.inf)


def test_keep_dense_host_branch_matches_jax():
    port, ref = _pair("random_network_problem",
                      dict(num_states=6, num_inputs=3, num_modes=3,
                           num_stages=4, stopping_time=4), 1,
                      keep_dense=True)
    assert port.K is not None and port.P is not None
    assert_same_problem(port, ref)


def test_stage_blocks_are_shared_per_pattern():
    """Consecutive stages with one mode pattern share one tensor, so the
    stage-grouped contractions collapse them (as in the JAX package)."""
    port, _ = _pair("mass_spring_problem", dict(num_stages=4), 1)
    assert all(w is port.ab_fwd[0] for w in port.ab_fwd)
    assert all(w is port.qr_bwd[0] for w in port.qr_bwd)


@pytest.mark.parametrize("fixture", [FIXTURES[0], FIXTURES[5], FIXTURES[7]],
                         ids=["demo", "mass_spring_chain",
                              "random_network_pad4"])
def test_from_numpy_of_jax_leaves(fixture):
    _, family, kwargs, pad = fixture
    port, ref = _pair(family, kwargs, pad)
    carried = from_numpy(*to_numpy(ref), device="cpu", dtype=torch.float64)
    assert_same_problem(carried, ref)
    for name in ("ab_fwd", "qr_fwd"):
        own, got = getattr(port, name), getattr(carried, name)
        for k0 in range(len(own)):
            for k in range(len(own)):
                assert (own[k] is own[k0]) == (got[k] is got[k0]), name


def test_from_numpy_rejects_multi_device_layouts():
    _, ref = _pair("lqr_binary_problem", {}, 1)
    leaves, static = to_numpy(dataclasses.replace(ref, frontier=1))
    with pytest.raises(NotImplementedError, match="item 14"):
        from_numpy(leaves, static, device="cpu")


def test_offline_device_not_ported():
    """The name predates the port of ``offline="device"``. On a fully
    tabled tree the option takes the host tables, as in the JAX package
    (the device branches are in tests/test_torch_offline.py); an unknown
    ``offline`` still raises."""
    spec, _ = port_models.lqr_binary_problem()
    port, ref = _pair("lqr_binary_problem", {}, 1, offline="device")
    assert port.K is None
    assert_same_problem(port, ref)
    with pytest.raises(ValueError, match="offline"):
        build_stacked(spec, offline="disk", device="cpu")


def test_default_dtype_follows_device():
    spec, _ = port_models.lqr_binary_problem()
    assert build_stacked(spec, device="cpu").dtype == torch.float64
    assert build_stacked(spec, dtype=np.float32,
                         device="cpu").dtype == torch.float32


@pytest.mark.parametrize("fixture", [FIXTURES[0], FIXTURES[7]],
                         ids=["demo", "random_network_pad4"])
def test_every_tensor_is_contiguous(fixture):
    """The CUDA kernels read raw row-major memory: NumPy results such as
    the stacked transposes of ``ab_fwd`` must not reach them strided."""
    _, family, kwargs, pad = fixture
    port, ref = _pair(family, kwargs, pad, keep_dense=True)
    carried = from_numpy(*to_numpy(ref), device="cpu", dtype=torch.float64)
    for sp in (port, carried):
        for f in dataclasses.fields(sp):
            v = getattr(sp, f.name)
            if hasattr(v, "modes"):
                v = (v.dense_m, v.modes, v.idx)
            for t in (v if isinstance(v, tuple) else (v,)):
                if isinstance(t, torch.Tensor):
                    assert t.is_contiguous(), f.name
