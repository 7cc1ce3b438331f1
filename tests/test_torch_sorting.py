"""The ray sort keys against the JAX package, on the CPU: ``morton3``,
``ray_sort_keys`` (with the dead-lane bit 31) and ``sort_permutation`` are
bit-equal to ``path_tracer_tpu/ops/sorting.py`` on seeded rays, ragged
counts included; and the JAX package's invariants (tests/test_sorting.py):
the round trip, and similar rays sharing keys.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_torch.ops import sorting


def _unit_rays(g, n):
    o = g.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::29, 2] = 0.0  # a direction component on a cell boundary
    return o, d


def test_morton3_equals_jax():
    from path_tracer_tpu.ops.sorting import morton3 as jax_morton3

    g = np.random.default_rng(0)
    ix, iy, iz = g.integers(0, 4096, (3, 5000)).astype(np.uint32)
    want = np.asarray(jax_morton3(*(jnp.asarray(x) for x in (ix, iy, iz))))
    got = sorting.morton3(*(torch.from_numpy(x.astype(np.int64))
                            for x in (ix, iy, iz)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 97, 4099, 65536])
@pytest.mark.parametrize("box", ["scene", "miss"])
def test_keys_and_permutation_equal_jax(n, box):
    """Keys (a fifth of the lanes dead) and both permutations bit-equal;
    ``miss`` keys against the (+inf, -inf) box of an empty tree."""
    from path_tracer_tpu.ops.sorting import ray_sort_keys, sort_permutation

    g = np.random.default_rng(n)
    o, d = _unit_rays(g, n)
    lo, hi = ((np.array([-2.0, -1.0, -2.5], np.float32),
               np.array([2.0, 1.5, 2.0], np.float32)) if box == "scene"
              else (np.full(3, np.inf, np.float32),
                    np.full(3, -np.inf, np.float32)))
    dead = g.uniform(size=n) < 0.2
    kj = ray_sort_keys(*(jnp.asarray(x) for x in (o, d, lo, hi)))
    kj = kj | jnp.where(jnp.asarray(dead), jnp.uint32(1) << 31,
                        jnp.uint32(0))
    kp = sorting.ray_sort_keys(*(torch.from_numpy(x) for x in (o, d, lo, hi)))
    kp = kp | torch.where(torch.from_numpy(dead), 1 << 31, 0)
    assert kp.dtype == torch.int64 and int(kp.min()) >= 0
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kj).astype(np.int64))
    pj, ij = sort_permutation(kj)
    pp, ip = sorting.sort_permutation(kp)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    assert not dead[pp.numpy()[:n - int(dead.sum())]].any()  # dead last


def test_sort_permutation_roundtrip():
    g = np.random.default_rng(0)
    o = torch.from_numpy(g.uniform(-5, 5, (1000, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(g.normal(size=(1000, 3)).astype(np.float32)), dim=1)
    keys = sorting.ray_sort_keys(o, d, torch.full((3,), -5.0),
                                 torch.full((3,), 5.0))
    perm, inv = sorting.sort_permutation(keys)
    assert (keys[perm].diff() >= 0).all()
    assert torch.equal(o[perm][inv], o)


def test_keys_group_similar_rays():
    lo, hi = torch.zeros(3), torch.ones(3)
    keys = lambda o, d: sorting.ray_sort_keys(torch.tensor(o),
                                              torch.tensor(d), lo, hi)
    # identical origin cell, opposite directions -> different keys
    k = keys([[0.1, 0.1, 0.1]] * 2, [[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    assert k[0] != k[1]
    # same direction, far-apart origins -> different keys
    up = [[0.0, 0.0, 1.0]] * 2
    k2 = keys([[0.05, 0.05, 0.05], [0.95, 0.95, 0.95]], up)
    assert k2[0] != k2[1]
    # nearby origins, same direction -> same key
    k3 = keys([[0.50, 0.50, 0.50], [0.51, 0.50, 0.50]], up)
    assert k3[0] == k3[1]
