"""Hardware probes (rtrt_tpu_torch/tools: K10 probe_cond, K11 / K12
probe_smem, K13 probe_pressure, K14 probe_broadcast, K15 probe_xpose, K16
probe_bf16) on the CPU.

The JAX side is each tool's own kernel, loaded from tools/*.py and run in
`pl.pallas_call(..., interpret=True)` with the in_specs, out_specs and
scratch shapes of the tool's `run`; the port's side is the plain PyTorch
version (what the wrappers run for CPU tensors), on the same numpy inputs.
probe_smem's kernels are closures inside `try_alloc` and `time_consume`:
the test calls those with the tool's `pl` swapped for a stand-in whose
`pallas_call` records the kernel and its specs and stops the call, then
runs the recorded kernel in interpret mode.  `time_consume("smem")` does
not lower in interpret mode: its DMA copies the (128, 128) table into the
(16384,) SMEM scratch, and the verifier refuses the shapes ("expect
operands to be compatible with body block return types ...
tensor<16384xf32> ... vs ... tensor<128x128xf32>"), so its reference is a
numpy transcription of probe_smem.py:52-81 with the table flattened.

Input recipes, beside each tool's own inputs (which hide most of what the
tools compute):
  * K10, K12, K13: x uniform in [0, 1) (it too reaches the consume's
    fixed point on every lane within a step), x uniform in [-400, 0)
    with x[0, 0] = inf, whose lanes stay apart and whose step index
    advances by 2 (probe_cond.spread_inputs), and x uniform in [0, 1)
    with x[0, 0] = 3e38, whose step flag is true after the first step
    only, or (K13 with planes) after every step (probe_cond.flip_inputs);
  * K11: x = 1 and x uniform in [0, 1), buffers of 1, 2 and 1024 floats;
  * K14: the tables times 1024, so that every sum shows above 2^30;
  * K15: dyadic rays and records on which every ray hits every record;
  * K16: x uniform in [-8, 8) at steps 1-8, before the chains converge.
Tolerances (measured here; the kernels equal these plain versions bit for
bit on the card, tests/test_torch_kernels_gpu.py):
  * bit-equal: K11, K12 smem against its transcription, K14, K15 on the
    dyadic recipe (every product exact), and every input where the JAX
    result already matches;
  * K10 and K12 extract: 1 ulp; K13: 2 ulps; K15 on the tool's rays: 4
    ulps.  XLA on the CPU contracts a * v0 + v1 (and K13's v1 * inv, K15's
    Moller-Trumbore dots) into FMAs; torch rounds the product first;
  * K16 float32: 2^-18 absolute (2 ulps of the chains' sum, |sum| < 32;
    also from XLA's FMA contraction).  K16 bf16: 2^-4 absolute, one bf16
    ulp of a chain before its clamp (|c| < 16).  XLA keeps float32 between
    the bf16 operations (its output is not even a bf16 value); torch, like
    the kernel, rounds every operation to bf16.
"""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rtrt_tpu_torch.tools import (probe_bf16, probe_broadcast, probe_cond,
                                  probe_pressure, probe_smem, probe_xpose)
from rtrt_tpu_torch.utils import timing

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 16
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
RECIPES = list(probe_cond.RECIPES)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tools():
    return {n: _jax_tool(n) for n in (
        "probe_cond", "probe_smem", "probe_pressure", "probe_broadcast",
        "probe_xpose", "probe_bf16")}


def _call(kernel, rows, n_in, scratch=(), **kw):
    return pl.pallas_call(
        kernel, in_specs=[VMEM] * n_in, out_specs=VMEM,
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.float32),
        scratch_shapes=list(scratch), interpret=True, **kw)


class _Recorded(Exception):
    pass


def _recorded_kernel(tool, fn, *args, **kwargs):
    """(kernel, pallas_call keywords) of the first pallas_call that
    tool.fn(*args) makes, recorded by a stand-in for the tool's `pl`."""
    seen = {}

    def record(kernel, **kw):
        seen.update(kernel=kernel, kw=kw)
        raise _Recorded

    real = tool.pl
    tool.pl = types.SimpleNamespace(pallas_call=record, BlockSpec=pl.BlockSpec,
                                    ds=pl.ds)
    try:
        getattr(tool, fn)(*args, **kwargs)  # try_alloc swallows _Recorded
    except _Recorded:
        pass
    finally:
        tool.pl = real
    return seen["kernel"], seen["kw"]


def _interpret(kernel, kw, *inputs):
    return np.asarray(pl.pallas_call(kernel, **kw, interpret=True)(*inputs))


# ---------------------------------------------------------------------------
# K10 probe_cond
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("mode", probe_cond.MODES)
def test_probe_cond_matches_jax(jax_tools, mode, recipe):
    tab, x = probe_cond.RECIPES[recipe](64, "cpu")
    kern = jax_tools["probe_cond"].make_kernel(mode, STEPS)
    ref = np.asarray(_call(kern, 64, 2)(tab.numpy(), x.numpy()))
    got = probe_cond.cond_probe(mode, tab, x, STEPS).numpy()
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)


@pytest.mark.parametrize("recipe", RECIPES)
def test_probe_cond_modes_agree(recipe):
    tab, x = probe_cond.RECIPES[recipe](64, "cpu")
    flat, cond, cond2 = (probe_cond.cond_probe(m, tab, x, STEPS)
                         for m in probe_cond.MODES)
    assert torch.equal(flat, cond) and torch.equal(flat, cond2)
    if recipe == "spread":  # the lanes stay apart; k advances by 2
        assert flat.unique().numel() > 5000 and torch.isinf(flat[0, 0])
        finite = x.clone()
        finite[0, 0] = 0.0  # k advances by 1: twice the visits, ~12 each
        twice = probe_cond.cond_probe("flat", tab, finite, STEPS)
        below = flat < -50  # not yet at the fixed point after 8 visits
        assert below.sum() > 4000
        assert torch.all(twice[below] - flat[below] > 48)


# ---------------------------------------------------------------------------
# K11 / K12 probe_smem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recipe", ["tool", "uniform"])
@pytest.mark.parametrize("n_floats", [1, 2, 1024])
def test_probe_smem_alloc_matches_jax(jax_tools, n_floats, recipe):
    kern, kw = _recorded_kernel(jax_tools["probe_smem"], "try_alloc",
                                n_floats)
    x = torch.ones(probe_cond.SHAPE) if recipe == "tool" else \
        probe_cond.uniform_inputs(64, "cpu")[1]
    ref = _interpret(kern, kw, x.numpy())
    got = probe_smem.smem_alloc(x, n_floats)
    np.testing.assert_array_equal(got.numpy(), ref)
    two = x[0, 1] + x[0, 1] if n_floats == 1 else x[0, 0] + x[0, 1]
    torch.testing.assert_close(got - x, two.expand_as(x))


@pytest.mark.parametrize("recipe", RECIPES)
def test_probe_smem_extract_matches_jax(jax_tools, recipe):
    kern, kw = _recorded_kernel(jax_tools["probe_smem"], "time_consume",
                                "extract", steps=STEPS)
    tab, x = probe_cond.RECIPES[recipe](64, "cpu")
    ref = _interpret(kern, kw, tab.numpy(), x.numpy())
    got = probe_smem.smem_consume("extract", tab, x, STEPS).numpy()
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    # extract is K10's function
    assert np.array_equal(got, probe_cond.cond_probe("flat", tab, x,
                                                     STEPS).numpy())


def _smem_consume_numpy(tab, x, steps):
    """probe_smem.py:52-81 in mode "smem", transcribed to numpy float32:
    the table flattened as the DMA stages it into the (16384,) scratch,
    value (base + 16 r + v) % 8000 of it."""
    smem = tab.reshape(-1)
    acc = x.copy()
    k = 0
    while k < steps:
        base = (k * 7) % 997
        vals = [smem[(base + 16 * r + v) % 8000] for r in range(8)
                for v in range(9)]
        a = acc
        for i in range(0, len(vals), 3):
            a = np.minimum(a * vals[i] + vals[i + 1], vals[i + 2] + a)
        k = k + 1 + int(a[0, 0] > 1e30)
        acc = a
    return acc


@pytest.mark.parametrize("recipe", RECIPES)
def test_probe_smem_staged_matches_transcription(recipe):
    tab, x = probe_cond.RECIPES[recipe](64, "cpu")
    ref = _smem_consume_numpy(tab.numpy(), x.numpy(), STEPS)
    got = probe_smem.smem_consume("smem", tab, x, STEPS).numpy()
    np.testing.assert_array_equal(got, ref)
    # the staged read is another function than extract
    other = probe_smem.smem_consume("extract", tab, x, STEPS).numpy()
    assert recipe != "spread" or not np.array_equal(got, other)


# ---------------------------------------------------------------------------
# K13 probe_pressure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("n_inv", probe_pressure.N_INV)
def test_probe_pressure_matches_jax(jax_tools, n_inv, recipe):
    rows = 8
    tab, x = probe_cond.RECIPES[recipe](rows, "cpu")
    kern = jax_tools["probe_pressure"].make_kernel(n_inv, rows, STEPS)
    ref = np.asarray(_call(kern, rows, 2)(tab.numpy(), x.numpy()))
    got = probe_pressure.pressure_probe(n_inv, tab, x, STEPS).numpy()
    np.testing.assert_array_max_ulp(got, ref, maxulp=2)


def _k_sequence(n_inv, steps):
    """The step indices k of the plain consume loop (K13 at n_inv, 8
    rows) on the flip recipe."""
    tab, x = probe_cond.flip_inputs(8, "cpu")
    fac = probe_pressure.factors(n_inv, "cpu")
    inv = [x * fac[p] for p in range(n_inv)]
    seen = []

    def gate(k):
        seen.append(k)
        return True

    probe_cond.consume_loop(x, steps, lambda b: probe_cond.row_values(tab, b),
                            (lambda p: inv[p % n_inv]) if n_inv else
                            (lambda p: 0.5), gate=gate)
    return seen


@pytest.mark.parametrize("n_inv", probe_pressure.N_INV)
def test_flip_recipe_turns_the_step_flag(n_inv):
    """Without planes acc[0, 0]'s flag is true after the first step only
    (k: 0, 2, 3, 4, ...); with planes it stays true (k: 0, 2, 4, ...).
    A block of the split K13 that misread or mistimed it would take
    another k sequence, and the card's tests would see it."""
    want = [0, 2, 3, 4, 5, 6, 7, 8, 9] if n_inv == 0 else [0, 2, 4, 6, 8]
    assert _k_sequence(n_inv, 10) == want


# ---------------------------------------------------------------------------
# K14 probe_broadcast
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recipe", list(probe_broadcast.RECIPES))
@pytest.mark.parametrize("mode", probe_broadcast.MODES)
def test_probe_broadcast_matches_jax(jax_tools, mode, recipe):
    """The plain K14 against the JAX tool's kernel (interpret mode), 64
    steps, bit-equal, on the tool's inputs, the scaled tables, and the
    saturating recipe (the scaled tables with pend % 32: every lane has
    retired by step 32, after which cand stays 2^30 and every lane adds
    record 0 each step)."""
    steps = 64
    tab, ttab, pend = probe_broadcast.RECIPES[recipe]("cpu")
    kern = jax_tools["probe_broadcast"].make_kernel(mode, steps)
    ref = np.asarray(_call(kern, 64, 3)(tab.numpy(), ttab.numpy(),
                                        pend.numpy()))
    got = probe_broadcast.broadcast_probe(mode, tab, ttab, pend, steps)
    np.testing.assert_array_equal(got.numpy(), ref)
    done = pend < steps  # the lanes the loop retired
    assert torch.all(got[~done] == pend[~done].float())
    if recipe == "tool":
        return
    # the record sums show, exact, above 2^30
    v = torch.arange(probe_broadcast.NVAL)
    rec = lambda p: tab.reshape(-1)[16 * p + v] if mode == "extract" \
        else ttab[(p // 128) * 16 + v, p % 128]
    own = rec(pend[done].long()[:, None]).sum(1)
    assert own.min() > 0
    if recipe == "scaled":
        assert torch.equal(got[done] - 2.0 ** 30, own)
    else:  # steps 32-63 add record 0 to every lane
        assert done.all()
        extra = (steps - 32) * rec(torch.tensor(0)).sum()
        assert extra > 0
        assert torch.equal(got[done] - 2.0 ** 30, own + extra)


# ---------------------------------------------------------------------------
# K15 probe_xpose
# ---------------------------------------------------------------------------


def _xpose_inputs(recipe, rows=8):
    make = probe_xpose.hit_inputs if recipe == "hit" else \
        probe_xpose.tool_inputs
    return make(rows, "cpu")


@pytest.mark.parametrize("recipe", ["tool", "hit"])
@pytest.mark.parametrize("mode", probe_xpose.MODES)
def test_probe_xpose_matches_jax(jax_tools, mode, recipe):
    tab, planes = _xpose_inputs(recipe)
    kern = jax_tools["probe_xpose"].make_kernel(mode, 8, STEPS, True)
    ref = np.asarray(_call(kern, 8, 7, [pltpu.SMEM((128,), jnp.int32)])(
        tab.numpy(), *planes.numpy()))
    got = probe_xpose.xpose_probe(mode, tab, planes, STEPS).numpy()
    if recipe == "hit":
        np.testing.assert_array_equal(got, ref)
        assert np.all(got < 1e3)  # every ray hit
    else:
        np.testing.assert_array_max_ulp(got, ref, maxulp=4)
        assert 0 < np.mean(got < 1e9) < 1


@pytest.mark.parametrize("recipe", ["tool", "hit"])
def test_probe_xpose_modes_agree(recipe):
    tab, planes = _xpose_inputs(recipe)
    a, b = (probe_xpose.xpose_probe(m, tab, planes, STEPS)
            for m in probe_xpose.MODES)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K16 probe_bf16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recipe", ["tool", "uniform"])
@pytest.mark.parametrize("dtype", list(probe_bf16.DTYPES))
def test_probe_bf16_matches_jax(jax_tools, dtype, recipe):
    make = probe_bf16.uniform_inputs if recipe == "uniform" else \
        probe_bf16.tool_inputs
    x = make(64, "cpu")
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    atol = 2.0 ** -4 if dtype == "bf16" else 2.0 ** -18
    for steps in range(1, 9):
        kern = jax_tools["probe_bf16"].make_kernel(jdt, steps)
        ref = np.asarray(_call(kern, 64, 1)(x.numpy()))
        got = probe_bf16.bf16_probe(dtype, x, steps)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)
        if dtype == "bf16":  # every operation rounded to bf16
            assert torch.equal(got, got.to(torch.bfloat16).float())
    if recipe == "uniform":  # not yet converged: the lanes differ
        assert got.unique().numel() > 4


# ---------------------------------------------------------------------------
# bounds and the command lines
# ---------------------------------------------------------------------------


def test_hw_probe_floors_count_the_work():
    """Each probe's floor is its operations on the SMs it fills (K10 and
    K13 4 at 64 rows, K13 1 at 8): positive, ordered as the modes add work,
    bf16 at twice the float32 rate."""
    assert timing.bound_ms(0, 134e9, rate=timing.BF16_OPS) == \
        pytest.approx((1.0, "operations"))
    c = probe_cond.bound(64, 400)
    assert c[1] == "operations" and c[0] > 0
    p = lambda n, rows: probe_pressure.bound(rows, 400,
                                             probe_pressure.lane_ops(n))[0]
    sms = probe_pressure.launch_geometry(64)[0]
    assert probe_cond.launch_geometry(64)[0] == sms
    assert p(0, 64) == pytest.approx(c[0]) and p(6, 64) == p(20, 64)
    assert p(6, 64) == pytest.approx(1.25 * p(0, 64))
    assert p(6, 8) == pytest.approx(p(6, 64) / 8 * sms)
    f32, bf16 = (probe_bf16.bound(d, 64, 4000) for d in probe_bf16.DTYPES)
    assert bf16[0] == pytest.approx(f32[0] / 2) and bf16[1] == "operations"
    assert probe_broadcast.bound(64, 800)[0] == \
        pytest.approx(2 * probe_broadcast.bound(64, 400)[0])
    assert probe_xpose.bound(32, 300)[1] == "operations"
    assert probe_smem.alloc_bound()[1] == "bytes"


@pytest.mark.parametrize("tool", [probe_cond, probe_smem, probe_pressure,
                                  probe_broadcast, probe_xpose, probe_bf16])
def test_hw_command_line_needs_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main([])
    assert capsys.readouterr().out == ""
