"""The port's multi-device paths (``path_tracer_torch.parallel``) in one
gloo world of 4 CPU processes, against the port's one-process paths and
the JAX package's on conftest's virtual 8-device CPU mesh.

One module fixture launches the world once (tests/tools/
torch_parallel_worker.py, a ``file://`` rendezvous in the test's temporary
directory, every process leaving the group on exit), and two
``torchrun`` runs of the CLI beside it; the JAX references are computed
here while they run. tests/test_parallel.py's Cornell box (the JAX
package's scene, carried across with ``scene.from_numpy``), 8x16 pixels,
2 bounces and walks of 2 steps:

- the sharded render, concatenated over ranks, is bit-equal to the port's
  one-process ``render_wavefront`` (every RNG draw keys off the lane's
  pixel, and the kernels' plain versions are lane-wise) and within rtol
  1e-3 / atol 1e-4 of JAX's ``render_sharded`` on ``default_mesh(8)``
  (tests/test_parallel.py's bound); rebalanced, it is bit-equal to
  unrebalanced over 2 samples;
- the exchange deals JAX's skewed state (tests/test_parallel.py, in its
  4-shard form) as JAX's ``_alive_first_all_to_all`` on
  ``default_mesh(4)`` does, losing no lane, each shard within one live
  lane of the mean;
- ``live_lane_counts`` on the cube equals JAX's as integers;
- the sharded train step's loss is bit-equal on every rank, the loss and
  the updated ``mat_albedo_factor`` within rtol 1e-5 of the one-process
  step and within rtol 1e-3 of JAX's sharded step (the port-against-JAX
  render bound of tests/test_torch_render.py), and the loss falls;
- ``render_multihost`` and the render driver's multi-rank route give
  every rank the one-process ``render()`` image, within one level of
  JAX's ``render()``;
- ``torchrun --nproc-per-node 2`` of ``path-tracer-torch render`` writes
  the one-process CLI's PNG byte for byte, and refuses ``--checkpoint``.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests" / "tools"))
import torch_parallel_worker as worker  # noqa: E402

WORLD = 4
W, H = worker.W, worker.H
CUBE = REPO / "tests" / "scenes" / "cube" / "scene.isf"
CLI_PROFILE = "resolution: {width: 20, height: 14}\nsamples: 2\nbounces: 1\n"


class _Runs:
    """The launched processes; each result waits for its processes."""

    def __init__(self, td: Path, js):
        from path_tracer_torch.scene.device_scene import (
            ARRAY_FIELDS,
            STATIC_FIELDS,
        )

        self.td = td
        self.js = js
        self.carried = {"fields": {f: np.asarray(getattr(js, f))
                                   for f in ARRAY_FIELDS},
                        "statics": {s: getattr(js, s) for s in STATIC_FIELDS}}
        with open(td / "scene.pkl", "wb") as f:
            pickle.dump(self.carried, f)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self.world = [self._start(
            [str(REPO / "tests" / "tools" / "torch_parallel_worker.py"),
             str(r), str(WORLD), str(td / "rdzv"), str(td / "scene.pkl"),
             str(CUBE), str(td)], env) for r in range(WORLD)]
        (td / "p.yaml").write_text(CLI_PROFILE)
        cli = ["-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "path_tracer_torch.cli",
               "render", str(CUBE), "-p", str(td / "p.yaml"), "-q",
               "--device", "cpu", "-o"]
        self.cli = self._start(cli + [str(td / "two.png")], env)
        self.refused = self._start(
            cli + [str(td / "no.png"), "--checkpoint", str(td / "r.ckpt")],
            env)
        self._ranks = None

    def _start(self, args, env):
        return subprocess.Popen([sys.executable, *args], cwd=self.td,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    @staticmethod
    def wait(procs) -> list:
        """(returncode, output) of each process."""
        out = []
        for p in procs:
            try:
                text, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
            out.append((p.returncode, text))
        return out

    def ranks(self) -> list:
        if self._ranks is None:
            done = self.wait(self.world)
            assert all(rc == 0 for rc, _ in done), "\n---\n".join(
                text for _, text in done)
            self._ranks = [dict(np.load(self.td / f"rank{r}.npz"))
                           for r in range(WORLD)]
        return self._ranks

    def kill(self):
        for p in self.world + [self.cli, self.refused]:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from path_tracer_tpu.scene.procedural import cornell_device_scene

    r = _Runs(tmp_path_factory.mktemp("torch_parallel"),
              cornell_device_scene())
    yield r
    r.kill()


@pytest.fixture(scope="module")
def jax_refs(runs):
    """The JAX package's results, each computed in a thread of its own
    while the processes run: {name: future}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(_JAX_REFS)) as pool:
        yield {name: pool.submit(fn, runs.js)
               for name, fn in _JAX_REFS.items()}


def _jax_sharded(js):
    import jax.numpy as jnp

    from path_tracer_tpu.parallel import default_mesh, render_sharded

    return np.asarray(render_sharded(
        js, default_mesh(8), jnp.arange(W * H, dtype=jnp.int32), W, H,
        jnp.int32(1), 1, _jax_spec()))


def _jax_exchange(_):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from path_tracer_tpu.parallel import default_mesh
    from path_tracer_tpu.parallel.render import _alive_first_all_to_all

    f = jax.jit(jax.shard_map(_alive_first_all_to_all("dp", WORLD),
                              mesh=default_mesh(WORLD), in_specs=(P("dp"),),
                              out_specs=P("dp"), check_vma=False))
    return [np.asarray(x) for x in f(tuple(jnp.asarray(x)
                                           for x in _skewed_state()))]


def _jax_live(_):
    import jax.numpy as jnp

    from path_tracer_tpu.models.integrator import IntegratorSpec
    from path_tracer_tpu.parallel import default_mesh
    from path_tracer_tpu.parallel.render import live_lane_counts
    from path_tracer_tpu.scene import load_scene

    return np.asarray(live_lane_counts(
        load_scene(CUBE), default_mesh(WORLD),
        jnp.arange(32 * 24, dtype=jnp.int32), 32, 24, jnp.int32(3),
        IntegratorSpec(bounces=5)))


def _jax_step(js):
    import jax.numpy as jnp

    from path_tracer_tpu.parallel import default_mesh, get_params
    from path_tracer_tpu.parallel import make_train_step

    step = make_train_step(default_mesh(WORLD), W, H,
                           _jax_spec(differentiable=True), n_samples=1,
                           lr=1e-4)
    p1, loss1 = step(get_params(js), js, jnp.arange(W * H, dtype=jnp.int32),
                     jnp.zeros((W * H, 3), jnp.float32), jnp.int32(1))
    return np.asarray(loss1), np.asarray(p1["mat_albedo_factor"])


def _jax_render(js):
    from path_tracer_tpu.config import Profile, Resolution
    from path_tracer_tpu.models.renderer import render

    p = worker.profile()
    return render(js, Profile(
        resolution=Resolution(W, H), samples=p.samples, bounces=p.bounces,
        alpha_walk_steps=2, shadow_walk_steps=2, tile_rays=p.tile_rays,
        samples_per_launch=p.samples_per_launch))


_JAX_REFS = {"sharded": _jax_sharded, "exchange": _jax_exchange,
             "live": _jax_live, "step": _jax_step, "render": _jax_render}


def _skewed_state() -> list:
    """The exchange's input over all shards (the worker's per rank)."""
    return [np.concatenate([worker.skewed_state(r)[i].numpy()
                            for r in range(WORLD)]) for i in range(7)]


@pytest.fixture(scope="module")
def port_scene(runs):
    from path_tracer_torch.scene import from_numpy

    return from_numpy(runs.carried["fields"], runs.carried["statics"], "cpu")


def _jax_spec(**kw):
    from path_tracer_tpu.models.integrator import IntegratorSpec

    return IntegratorSpec(bounces=worker.BOUNCES, alpha_walk_steps=2,
                          shadow_walk_steps=2, tri_block=256, **kw)


def _cat(ranks, key):
    return np.concatenate([z[key] for z in ranks])


def test_sharded_render_is_the_one_process_render(runs, jax_refs,
                                                  port_scene):
    from path_tracer_torch.models.integrator import render_wavefront

    one = render_wavefront(port_scene, torch.arange(W * H, dtype=torch.int32),
                           W, H, 1, worker._spec()).numpy()
    got = _cat(runs.ranks(), "sharded1")
    assert got.std() > 0
    np.testing.assert_array_equal(got, one)
    np.testing.assert_allclose(got, jax_refs["sharded"].result(), rtol=1e-3,
                               atol=1e-4)


def test_rebalanced_equals_unrebalanced(runs):
    for z in runs.ranks():
        np.testing.assert_array_equal(z["rebalanced2"], z["sharded2"])
    assert not np.array_equal(_cat(runs.ranks(), "sharded2"),
                              2 * _cat(runs.ranks(), "sharded1"))


def test_exchange_deals_as_jax(runs, jax_refs):
    want = jax_refs["exchange"].result()
    ranks = runs.ranks()
    for i in range(7):
        np.testing.assert_array_equal(_cat(ranks, f"ex{i}"), want[i])
    # No lane lost or duplicated; live counts within one of the mean.
    assert sorted(_cat(ranks, "ex5").tolist()) == list(range(8 * WORLD))
    alive = _skewed_state()[4]
    live = np.array([z["ex4"].sum() for z in ranks])
    assert live.sum() == alive.sum() == 6
    assert np.abs(live - alive.sum() / WORLD).max() <= 1, live


def test_live_lane_counts_match_jax(runs, jax_refs):
    want = jax_refs["live"].result()
    for z in runs.ranks():
        assert z["live"].dtype == np.int32 and z["live"].shape == (WORLD, 6)
        np.testing.assert_array_equal(z["live"], want)
    assert (want[:, 0] == 32 * 24 // WORLD).all() and want[:, 1].max() > 0


def test_sharded_train_step(runs, jax_refs, port_scene):
    from path_tracer_torch.parallel import get_params, make_train_step

    step = make_train_step(W, H, worker._spec(differentiable=True),
                           n_samples=1, lr=1e-4)
    p0 = get_params(port_scene)
    p1, loss1 = step(p0, port_scene, torch.arange(W * H, dtype=torch.int32),
                     torch.zeros((W * H, 3)), 1)
    ranks = runs.ranks()
    for key in ("loss1", "loss2", "albedo1"):
        for z in ranks[1:]:
            np.testing.assert_array_equal(z[key], ranks[0][key])
    z = ranks[0]
    np.testing.assert_allclose(z["loss1"], loss1.numpy(), rtol=1e-5)
    np.testing.assert_allclose(z["albedo1"],
                               p1["mat_albedo_factor"].numpy(), rtol=1e-5)
    jloss1, jalbedo1 = jax_refs["step"].result()
    np.testing.assert_allclose(z["loss1"], jloss1, rtol=1e-3)
    np.testing.assert_allclose(z["albedo1"], jalbedo1, rtol=1e-3)
    assert float(z["loss2"]) < float(z["loss1"])
    assert not np.array_equal(z["albedo1"],
                              p0["mat_albedo_factor"].numpy())


def test_multihost_render_is_the_one_process_render(runs, jax_refs,
                                                    port_scene):
    from path_tracer_torch.models.renderer import render

    one = render(port_scene, worker.profile())
    assert one.shape == (H, W, 3) and one.std() > 0
    for z in runs.ranks():
        np.testing.assert_array_equal(z["multihost"], one)
        # The driver's route: spw 2 falls back to 1 on several ranks.
        np.testing.assert_array_equal(z["render_route"], one)
        assert "samples_per_wavefront=2 unsupported" in str(
            z["route_printed"])
    diff = np.abs(one.astype(int) - jax_refs["render"].result().astype(int))
    assert diff.max() <= 1, f"{(diff > 0).sum()} texels off JAX's"


def test_mesh_and_deal_errors_and_slices(runs):
    ranks = runs.ranks()
    for r, z in enumerate(ranks):
        assert str(z["mesh_error"]) == \
            f"requested {WORLD + 1} devices but only {WORLD} available"
        assert "divisible by the mesh size (4)" in str(z["deal_error"])
        assert tuple(z["slice"]) == ((2 * r, 2 * r + 2) if r < WORLD - 1
                                     else (6, 10))
        assert set(z["transports"]) == {"all_gather_into_tensor:gloo:cpu",
                                        "all_reduce:gloo:cpu",
                                        "all_to_all_single:gloo:cpu"}


def test_two_rank_cli_writes_the_one_process_png(runs):
    from path_tracer_torch import cli

    one = runs.td / "one.png"
    cli.main(["render", str(CUBE), "-p", str(runs.td / "p.yaml"), "-q",
              "--device", "cpu", "-o", str(one)])
    (rc, text), (rc_no, text_no) = runs.wait([runs.cli, runs.refused])
    assert rc == 0, text
    assert (runs.td / "two.png").read_bytes() == one.read_bytes()
    assert rc_no != 0 and not (runs.td / "no.png").exists()
    assert "--checkpoint is not supported in a render of more than one " \
           "rank" in text_no
