"""The port's checkpoints (nenbody_tpu_torch.utils.checkpoint) against the
JAX package's (nenbody_tpu.utils.checkpoint) on shared numpy inputs.

Tolerances: none. A checkpoint moves arrays through npz unchanged, so every
comparison is exact: a JAX scene checkpoint loads into the port with equal
pos/vel/t, the port's own round trip is bit-exact with its generator, the
periodic checkpointer names and keeps the same files as the JAX one, and
both strict-match errors carry the JAX function's message word for word.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu import SimConfig as JSimConfig
from nenbody_tpu import state as jstate
from nenbody_tpu.utils import checkpoint as jck

from nenbody_tpu_torch import SceneState, SimConfig
from nenbody_tpu_torch import state as tstate
from nenbody_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)


def _jax_state(batch, n=12, t=7, seed=0):
    rng = np.random.RandomState(seed)
    lead = () if batch is None else (batch,)
    st = (jstate.spawn(jax.random.key(seed), JSimConfig(n=n)) if batch is None
          else jstate.spawn_batch(jax.random.key(seed), JSimConfig(n=n), batch))
    return st.replace(pos=jnp.asarray(rng.randn(*lead, n, 2).astype(np.float32)),
                      vel=jnp.asarray(rng.randn(*lead, n, 2).astype(np.float32)),
                      t=jnp.full(lead, t, jnp.int32))


@pytest.mark.parametrize("batch", [None, 3])
def test_jax_scene_checkpoint_loads_into_the_port(tmp_path, batch):
    jst = _jax_state(batch)
    path = jck.save_state(str(tmp_path / "j.npz"), jst)
    st, stream = ck.load_state(path, "cpu")
    assert stream is None  # the JAX key has no torch counterpart
    for name in ("pos", "vel", "t"):
        got, want = getattr(st, name).numpy(), np.asarray(getattr(jst, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("batch", [None, 2])
def test_port_round_trip_is_bit_exact_with_the_generator(tmp_path, batch):
    cfg = SimConfig(n=9)
    gen = torch.Generator().manual_seed(3)
    st = tstate.spawn(cfg, gen, "cpu") if batch is None else tstate.spawn_batch(cfg, gen, batch, "cpu")
    st = st.replace(t=st.t + 41)
    path = ck.save_state(str(tmp_path / "s"), st, gen)
    assert path.endswith(".npz") and os.path.exists(path)
    back, stream = ck.load_state(path, "cpu")
    for name in ("pos", "vel", "t"):
        assert torch.equal(getattr(back, name), getattr(st, name)), name
    restored = torch.Generator()
    restored.set_state(stream)
    assert torch.equal(torch.rand(5, generator=restored), torch.rand(5, generator=gen))
    # the port's file is a JAX scene file too, apart from the key JAX would want
    with np.load(path) as z:
        assert set(z.files) == {"pos", "vel", "t", "generator"}


def test_periodic_checkpointer_keeps_the_jax_files(tmp_path):
    """The same sequence of chunk-boundary steps (strides that do not divide
    `every`) saves the same filenames and keeps the same last `keep` files
    in both packages; latest() agrees, also from a fresh instance."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jck_ = jck.PeriodicCheckpointer(str(jdir), every=20, keep=2)
    tck = ck.PeriodicCheckpointer(str(tdir), every=20, keep=2)
    jst = _jax_state(None, n=4)
    st = SceneState(pos=torch.zeros(4, 2), vel=torch.zeros(4, 2), t=torch.tensor(0, dtype=torch.int32))
    gen = torch.Generator().manual_seed(0)
    saved = []
    for t in range(7, 120, 7):
        a = jck_.maybe_save(jst.replace(t=jnp.int32(t)))
        b = tck.maybe_save(st.replace(t=torch.tensor(t, dtype=torch.int32)), gen)
        assert (a is None) == (b is None), t
        if a is not None:
            assert os.path.basename(a) == os.path.basename(b)
            saved.append(os.path.basename(a))
    assert saved == ["state_000000021.npz", "state_000000042.npz", "state_000000063.npz",
                     "state_000000084.npz", "state_000000105.npz"]
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == saved[-2:]
    assert os.path.basename(jck_.latest()) == os.path.basename(tck.latest())
    assert (os.path.basename(jck.PeriodicCheckpointer(str(jdir)).latest())
            == os.path.basename(ck.PeriodicCheckpointer(str(tdir)).latest()) == saved[-1])


def test_save_pytree_names_leaves_as_the_jax_package(tmp_path):
    """A nested mapping saves under jax.tree_util.keystr's names, and each
    package's load_pytree reads the other's file."""
    rng = np.random.RandomState(1)
    tree = {"params": {"Dense_0": {"kernel": rng.randn(3, 4).astype(np.float32),
                                   "bias": rng.randn(4).astype(np.float32)},
                       "log_std": rng.randn(2).astype(np.float32)}}
    jpath = jck.save_pytree(str(tmp_path / "j"), jax.tree_util.tree_map(jnp.asarray, tree))
    tpath = ck.save_pytree(str(tmp_path / "t"), tree)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    back = ck.load_pytree(jpath, tree)
    jback = jck.load_pytree(tpath, jax.tree_util.tree_map(jnp.asarray, tree))
    for got in (back, jax.tree_util.tree_map(np.asarray, jback)):
        assert np.array_equal(got["params"]["Dense_0"]["kernel"], tree["params"]["Dense_0"]["kernel"])
        assert np.array_equal(got["params"]["log_std"], tree["params"]["log_std"])


@pytest.mark.parametrize("case", ["missing leaf", "shape mismatch"])
def test_load_pytree_matching_errors_are_the_jax_ones(tmp_path, case):
    saved = {"params": {"a": np.zeros(3, np.float32), "b": np.zeros((2, 2), np.float32)}}
    like = ({"params": {"a": np.zeros(3, np.float32), "c": np.zeros(1, np.float32)}}
            if case == "missing leaf" else
            {"params": {"a": np.zeros(3, np.float32), "b": np.zeros((2, 3), np.float32)}})
    path = ck.save_pytree(str(tmp_path / "p.npz"), saved)
    with pytest.raises(ValueError) as got:
        ck.load_pytree_matching(path, like, what="--net mlp params")
    with pytest.raises(ValueError) as want:
        jck.load_pytree_matching(path, jax.tree_util.tree_map(jnp.asarray, like),
                                 what="--net mlp params")
    assert str(got.value) == str(want.value)
    assert ("do not contain leaf ['params']['c']" if case == "missing leaf"
            else "has shape (2, 2), expected (2, 3)") in str(got.value)
