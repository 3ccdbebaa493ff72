"""Traversal-step probes (rtrt_tpu_torch/tools: K6 ubench_step, K7
probe_leaf, K8 / K9 probe_cores) and K1's step cap, on the CPU.

The JAX side is each tool's own `make_kernel`, loaded from tools/*.py and
wrapped in `pl.pallas_call(..., interpret=True)` with the in_specs,
out_specs and scratch shapes of the tool's `main` / `run`; the port's side
is the plain PyTorch version (what the wrappers run for CPU tensors).  Both
get the same numpy inputs, in two recipes:
  (a) the tool's own inputs;
  (b) for K7-K9, rays that hit every leaf record and every box
      (probe_leaf.hit_inputs, probe_cores.hit_inputs).  K7 writes
      best + bound and K8/K9 best + slot + bound + drops; while any lane
      misses, bound stays 1e9, whose float32 spacing (64) hides everything
      else, so (a) alone would test little.
Tolerances:
  * K6: exact for loop and fetch.  The other modes read iy = 1 / (ox * 1.1
    + 2) and iz (0.9): XLA on the CPU contracts that product and sum into
    one FMA, torch rounds twice, so iy / iz differ by one ulp on ~10% of
    lanes, and the slab distances summed over the steps carry it as a few
    ulps (3 at most here; with the FMA emulated in the plain version the
    two agree bit for bit): rtol 2^-20 (8 ulps).
  * K7-K9 on both recipes: bit-equal.  Recipe (b) lies on a coarse dyadic
    grid, so every product is exact and contraction cannot matter; on
    recipe (a) the outputs are 1e9-dominated.
K1's cap (bvh/packet.py, max_steps / count_steps) is held here against the
plain traversal's own visit count; the JAX kernel caps a tile's shared
loop, not a ray's, so it is not a reference for capped results.  The
kernels themselves are held to these plain versions on the card in
tests/test_torch_kernels_gpu.py.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rtrt_tpu_torch.bvh import packet as P
from rtrt_tpu_torch.bvh.sah import build_scene_tables_sah, bvh4_nodes
from rtrt_tpu_torch.engine.scene import build_demo_scene, padded_arrays
from rtrt_tpu_torch.tools import (probe_cores, probe_leaf, probe_traverse,
                                  ubench_step)
from rtrt_tpu_torch.utils import timing

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, STEPS = 8, 24
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tools():
    return {n: _jax_tool(n) for n in ("ubench_step", "probe_leaf",
                                      "probe_cores")}


def _out(shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


@pytest.mark.parametrize("mode", ubench_step.MODES)
def test_ubench_step_matches_jax(jax_tools, mode):
    tab, ox = ubench_step.tool_inputs(ROWS, "cpu")
    kern = jax_tools["ubench_step"].make_kernel(mode, STEPS, ROWS)
    ref = np.asarray(pl.pallas_call(
        kern, in_specs=[VMEM] * 2, out_specs=VMEM,
        out_shape=_out((ROWS, 128)), interpret=True)(tab.numpy(),
                                                    ox.numpy()))
    got = ubench_step.step_probe(mode, tab, ox, STEPS).numpy()
    if mode in ("loop", "fetch"):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -20, atol=0)


def _leaf_inputs(recipe):
    make = probe_leaf.hit_inputs if recipe == "hit" else \
        probe_leaf.tool_inputs
    return make(ROWS, "cpu")


@pytest.mark.parametrize("recipe", ["tool", "hit"])
@pytest.mark.parametrize("mode", probe_leaf.MODES)
def test_probe_leaf_matches_jax(jax_tools, mode, recipe):
    tab, planes = _leaf_inputs(recipe)
    kern = jax_tools["probe_leaf"].make_kernel(mode, ROWS, STEPS)
    ref = np.asarray(pl.pallas_call(
        kern, in_specs=[VMEM] * 7, out_specs=VMEM,
        out_shape=_out((ROWS, 128)),
        scratch_shapes=[pltpu.SMEM((128,), jnp.int32)],
        interpret=True)(tab.numpy(), *planes.numpy()))
    got = probe_leaf.leaf_probe(mode, tab, planes, STEPS).numpy()
    np.testing.assert_array_equal(got, ref)
    if recipe == "hit" and mode != "nored":  # the bound is finite
        assert np.all(got < 1e3)


@pytest.mark.parametrize("recipe", ["tool", "hit"])
@pytest.mark.parametrize("mode", probe_cores.MODES)
def test_probe_cores_matches_jax(jax_tools, mode, recipe):
    make = probe_cores.hit_inputs if recipe == "hit" else \
        probe_cores.tool_inputs
    ntab, ttab, planes = make(ROWS, device="cpu")
    planes = planes[:, 0].contiguous()
    kern = jax_tools["probe_cores"].make_kernel(mode, ROWS, STEPS)
    stack = probe_cores.STACK
    ref = np.asarray(pl.pallas_call(
        kern, in_specs=[VMEM] * 8, out_specs=VMEM,
        out_shape=_out((ROWS, 128)),
        scratch_shapes=[pltpu.SMEM((stack,), jnp.int32),
                        pltpu.SMEM((stack,), jnp.float32)],
        interpret=True)(ntab.numpy(), ttab.numpy(), *planes.numpy()))
    got, visits = probe_cores.cores_probe(mode, ntab, ttab, planes, STEPS)
    np.testing.assert_array_equal(got.numpy(), ref)
    n_leaf, n_int = visits.tolist()
    assert n_leaf + n_int <= STEPS
    assert (n_leaf > 0) == (mode != "intonly")
    assert (n_int > 0) == (mode != "leafonly")
    if recipe == "hit" and mode != "intonly":
        assert np.all(got.numpy() < 1e4)


def _jax_grid_call(inner, tiles, rows, nrows, trows):
    """The tool's gridded call (tools/probe_cores.py:229-262): ANY-space
    tables copied into VMEM scratch at grid step 0, one ray tile per grid
    step."""
    shape = (rows, 128)

    def kern(n_ref, t_ref, *args):
        refs, out_ref = args[:6], args[6]
        stack_ref, tstack_ref, n_v, t_v, sem = args[7:]

        @pl.when(pl.program_id(0) == 0)
        def _copy():
            pltpu.make_async_copy(n_ref, n_v, sem.at[0]).start()
            pltpu.make_async_copy(t_ref, t_v, sem.at[1]).start()
            pltpu.make_async_copy(n_ref, n_v, sem.at[0]).wait()
            pltpu.make_async_copy(t_ref, t_v, sem.at[1]).wait()

        inner(n_v, t_v, *[r[0] for r in refs], out_ref.at[0], stack_ref,
              tstack_ref)

    spec = pl.BlockSpec((1,) + shape, lambda i: (i, 0, 0),
                        memory_space=pltpu.VMEM)
    stack = probe_cores.STACK
    return pl.pallas_call(
        kern, grid=(tiles,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 2 + [spec] * 6,
        out_specs=spec, out_shape=_out((tiles,) + shape),
        scratch_shapes=[pltpu.SMEM((stack,), jnp.int32),
                        pltpu.SMEM((stack,), jnp.float32),
                        pltpu.VMEM((nrows, 128), jnp.float32),
                        pltpu.VMEM((trows, 128), jnp.float32),
                        pltpu.SemaphoreType.DMA((2,))],
        interpret=True)


@pytest.mark.parametrize("recipe", ["tool", "hit"])
def test_probe_cores_grid_matches_jax(jax_tools, recipe):
    tiles, steps = 2, 16
    make = probe_cores.hit_inputs if recipe == "hit" else \
        probe_cores.tool_inputs
    ntab, ttab, planes = make(ROWS, tiles, device="cpu")
    inner = jax_tools["probe_cores"].make_kernel("both", ROWS, steps)
    ref = np.asarray(_jax_grid_call(inner, tiles, ROWS, ntab.shape[0],
                                    ttab.shape[0])(
        ntab.numpy(), ttab.numpy(), *planes.numpy()))
    got, visits = probe_cores.cores_probe_grid("both", ntab, ttab, planes,
                                               steps)
    assert got.shape == (tiles, ROWS, 128) and visits.shape == (tiles, 2)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the tiles are independent: each equals the one-tile probe on its rays
    for b in range(tiles):
        one, v = probe_cores.cores_probe("both", ntab, ttab, planes[:, b],
                                         steps)
        assert torch.equal(one, got[b]) and torch.equal(v, visits[b])


def test_probe_floors_count_the_work():
    """Each mode's floor is its float operations on one SM: positive,
    ordered as the modes add work, and the cores bound follows the visits."""
    f = lambda m: ubench_step.bound(m, 64, 4000)
    assert f("loop")[0] < f("slab")[0] < f("reduce4")[0]
    assert f("carry4")[0] < f("carry12")[0] == f("cond12")[0]
    assert all(f(m)[1] == "operations" for m in ubench_step.MODES
               if m not in ("loop", "fetch"))
    g = lambda m: probe_leaf.bound(m, 32, 400)[0]
    assert g("rec2") < g("nomath") < g("full") == g("carry4")
    ntab, ttab, planes = probe_cores.tool_inputs(8, device="cpu")
    leaf = probe_cores.bound(ntab, ttab, planes, torch.tensor([400, 0]))
    both = probe_cores.bound(ntab, ttab, planes, torch.tensor([400, 400]))
    assert 0 < leaf[0] < both[0] and both[1] == "operations"
    grid = probe_cores.bound(ntab, ttab, torch.cat([planes] * 8, 1),
                             torch.tensor([[400, 400]] * 8))
    assert grid[0] == pytest.approx(both[0], rel=1e-9)  # 8 tiles on 8 SMs


# ---------------------------------------------------------------------------
# K1's step cap
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene_rays():
    host = build_demo_scene()
    pad = padded_arrays(host)
    bvh, nrm, mat = build_scene_tables_sah(
        host.num_batches, pad["indices"], pad["tri_mat"], pad["valid"],
        host.vertices, host.normals, leaf_max=8)
    tables = P.pack_tables(bvh, nrm, mat, bvh4_nodes(bvh))
    rng = np.random.default_rng(3)
    n = 2048
    org = rng.uniform(-6, 6, (n, 3)) + [0, 3, -9]
    d = rng.uniform(-4, 4, (n, 3)) + [0, 1, 0] - org
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    org, d = (torch.from_numpy(x.astype(np.float32)) for x in (org, d))
    visits = [0, 0]
    free = P.packet_intersect_plain(tables, org, d, visits=visits)
    counted = P.packet_intersect(tables, org, d, count_steps=True)
    return tables, org, d, free, visits, counted


def _same_hits(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("t", "tri", "u", "v", "mat", "ns", "ng"))


def test_count_steps_counts_the_plain_visits(scene_rays):
    _, _, _, free, visits, counted = scene_rays
    assert free.steps is None
    assert _same_hits(counted, free)
    assert counted.steps.dtype == torch.int32
    assert int(counted.steps.sum()) == visits[0] + visits[1]
    assert (free.tri >= 0).float().mean() > 0.3 and visits[1] > 0


def test_cap_that_never_binds_changes_nothing(scene_rays):
    tables, org, d, free, _, counted = scene_rays
    cap = int(counted.steps.max())
    hit = P.packet_intersect(tables, org, d, max_steps=cap,
                             count_steps=True)
    assert _same_hits(hit, free)
    assert torch.equal(hit.steps, counted.steps)


@pytest.mark.parametrize("cap", [1, 3])
def test_binding_cap_stops_each_ray(scene_rays, cap):
    """A capped ray makes exactly min(its visits, cap) visits; rays that
    finish under the cap keep their hit; a cut ray's hit, if any, is a real
    hit no nearer than the closest one."""
    tables, org, d, free, _, counted = scene_rays
    hit = P.packet_intersect(tables, org, d, max_steps=cap,
                             count_steps=True)
    assert torch.equal(hit.steps, torch.clamp(counted.steps, max=cap))
    done = counted.steps <= cap
    cut = ~done
    assert cut.any() and done.any()
    assert torch.equal(hit.tri[done], free.tri[done])
    assert torch.equal(hit.t[done], free.t[done])
    h = cut & (hit.tri >= 0)
    assert torch.all(hit.t[h] >= free.t[h])
    # stopping early never invents a hit: the uncapped ray hits too
    assert not torch.any((hit.tri[cut] >= 0) & (free.tri[cut] < 0))


def test_any_hit_cap(scene_rays):
    tables, org, d, _, _, _ = scene_rays
    visits = [0, 0]
    any_free = P.packet_intersect_plain(tables, org, d, any_hit=True,
                                        visits=visits)
    capped = P.packet_intersect(tables, org, d, any_hit=True, max_steps=2,
                                count_steps=True)
    assert int(capped.steps.max()) <= 2
    full = P.packet_intersect(tables, org, d, any_hit=True, count_steps=True)
    assert int(full.steps.sum()) == visits[0] + visits[1]
    assert torch.equal(full.tri, any_free.tri)


# ---------------------------------------------------------------------------
# timing and the command lines: device numbers only
# ---------------------------------------------------------------------------


def test_timing_refuses_cpu_results():
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="card"):
        timing.force_ready(x)
    with pytest.raises(ValueError, match="card"):
        timing.time_chained(lambda _: x, reps=2)
    with pytest.raises(ValueError, match="card"):
        timing.time_ms(lambda: (x, x), 2)


@pytest.mark.parametrize("result", ["tensor", "tuple"])
def test_time_graph_refuses_cpu_results(result):
    """time_graph_ms raises on a CPU result after its one warm-up call,
    before it captures anything."""
    x = torch.zeros(3)
    calls = []

    def fn():
        calls.append(1)
        return x if result == "tensor" else (x, x)

    with pytest.raises(ValueError, match="card"):
        timing.time_graph_ms(fn, launches=2, reps=2)
    assert len(calls) == 1


def test_bound_ms_scales_with_the_share_of_sms():
    one = timing.bound_ms(0, 67e9)
    assert one == pytest.approx((1.0, "operations"))
    assert timing.bound_ms(0, 67e9, share=1 / 132)[0] == \
        pytest.approx(132.0)
    assert timing.bound_ms(3.35e9, 0) == pytest.approx((1.0, "bytes"))


@pytest.mark.parametrize("tool", [ubench_step, probe_leaf, probe_cores,
                                  probe_traverse])
def test_command_line_needs_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tool.main([])
    assert capsys.readouterr().out == ""
