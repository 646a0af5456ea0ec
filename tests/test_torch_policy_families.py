"""The port's other policy families (ValueMLP, CentralValueMLP, ConvPolicy,
GRUPolicy) against the JAX package's flax modules, their weights carried
across by state_dict_from_flax, on shared numpy inputs; the twins of
tests/test_ppo.py's critic test, tests/test_conv_policy.py and
tests/test_recurrent.py's policy tests.

Tolerances: fp32 forwards to rtol 1e-5 / atol 1e-6 (the same products
summed in another order; tests/test_torch_policy_env.py's); the recurrent
forward over 5 steps to rtol 1e-5 / atol 1e-6. bf16 forwards to atol 2e-3,
half a bf16 step at 1 (both round inputs, weights and activations to 8
bits but may round the sums at other points), except ConvPolicy's, whose
bf16 conv sums 5-tap windows over 16 channels before the flatten: atol
4e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nenbody_tpu.rl import policy as jpolicy

from nenbody_tpu_torch.rl import policy

torch.set_num_threads(1)

W = 16
OBS = W + 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _obs(shape, seed):
    rng = np.random.RandomState(seed)
    line = rng.uniform(0.2, 1.0, shape + (W,))
    ego = rng.uniform(-0.5, 0.5, shape + (2,))
    return np.concatenate([line, ego], axis=-1).astype(np.float32)


def _pair(family, use_bf16, **kw):
    """(flax module, the port's module) of one family."""
    if family == "ValueMLP":
        return jpolicy.ValueMLP(use_bf16=use_bf16), policy.ValueMLP(OBS, use_bf16=use_bf16)
    if family == "CentralValueMLP":
        return (jpolicy.CentralValueMLP(use_bf16=use_bf16),
                policy.CentralValueMLP(OBS, use_bf16=use_bf16))
    if family == "ConvPolicy":
        return (jpolicy.ConvPolicy(vision_width=W, use_bf16=use_bf16, **kw),
                policy.ConvPolicy(OBS, W, use_bf16=use_bf16, **kw))
    return (jpolicy.GRUPolicy(use_bf16=use_bf16, **kw),
            policy.GRUPolicy(OBS, use_bf16=use_bf16, **kw))


def _crossed(family, use_bf16, obs, seed=0, **kw):
    """(flax module, its params, the port's module holding them)."""
    jmod, mod = _pair(family, use_bf16, **kw)
    if family == "GRUPolicy":
        params = jmod.init(jax.random.key(seed), jmod.initial_carry(obs.shape[:-1]),
                           jnp.asarray(obs))
    else:
        params = jmod.init(jax.random.key(seed), jnp.asarray(obs))
    mod.load_state_dict(policy.state_dict_from_flax(mod, _np(params)), strict=True)
    return jmod, params, mod


@pytest.mark.parametrize("family", ["ValueMLP", "CentralValueMLP", "ConvPolicy", "GRUPolicy"])
def test_state_dict_crossing_is_complete(family):
    """Every entry of the port's state_dict comes from the flax params, in
    its shape, and the layer counts must match."""
    obs = _obs((2, 3), 0)
    jmod, mod = _pair(family, False)
    params = (jmod.init(jax.random.key(0), jmod.initial_carry((2, 3)), jnp.asarray(obs))
              if family == "GRUPolicy" else jmod.init(jax.random.key(0), jnp.asarray(obs)))
    sd = policy.state_dict_from_flax(mod, _np(params))
    assert set(sd) == set(mod.state_dict())
    for k, v in mod.state_dict().items():
        assert sd[k].shape == v.shape, k
    other = policy.MLPPolicy(OBS, hidden=(8, 8, 8))  # a module of another family
    with pytest.raises(ValueError, match="flax params"):
        policy.state_dict_from_flax(other, _np(params))


@pytest.mark.parametrize("family", ["ValueMLP", "CentralValueMLP"])
@pytest.mark.parametrize("use_bf16", [False, True])
def test_value_heads_match_flax(family, use_bf16):
    obs = _obs((3, 5), 1)
    jmod, params, mod = _crossed(family, use_bf16, obs)
    want = np.asarray(jmod.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        got = mod(torch.from_numpy(obs)).numpy()
    assert got.shape == want.shape == (3, 5) and got.dtype == np.float32
    tol = dict(rtol=0, atol=2e-3) if use_bf16 else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, **tol)


def test_central_value_is_permutation_invariant():
    """V(s) pools the agent axis: every agent of an env gets one value,
    permuting the agents changes nothing, and the same weights take any N
    (tests/test_ppo.py::test_central_value_permutation_invariant)."""
    obs = _obs((3, 8), 2)
    _, _, mod = _crossed("CentralValueMLP", False, obs)
    with torch.no_grad():
        v = mod(torch.from_numpy(obs))
        perm = torch.from_numpy(np.random.RandomState(3).permutation(8))
        v_p = mod(torch.from_numpy(obs)[:, perm])
        v_4 = mod(torch.from_numpy(obs)[:, :4])
    assert v.shape == (3, 8) and torch.equal(v, v[:, :1].expand(3, 8))
    torch.testing.assert_close(v_p, v, rtol=1e-5, atol=1e-6)
    assert v_4.shape == (3, 4)


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("shape", [(7,), (3, 5), ()])
def test_conv_policy_matches_flax(use_bf16, shape):
    """ConvPolicy's forward at any leading batch dims (none, one, two)
    against flax's: 'SAME' padding, the channel-last flatten and the ego
    features joined after the convs."""
    obs = _obs(shape, 4)
    jmod, params, mod = _crossed("ConvPolicy", use_bf16, obs)
    want_mean, want_log_std = jmod.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        mean, log_std = mod(torch.from_numpy(obs))
    assert mean.shape == shape + (2,) and mean.dtype == torch.float32
    tol = dict(rtol=0, atol=4e-3) if use_bf16 else dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), **tol)
    np.testing.assert_array_equal(log_std.detach().numpy(), np.asarray(want_log_std))


@pytest.mark.parametrize("width,kernel,stride", [(16, 5, 2), (13, 5, 2), (10, 4, 3)])
def test_conv_policy_other_shapes_match_flax(width, kernel, stride):
    """Odd widths, even kernels and stride 3: the 'SAME' padding's
    asymmetric split (lo = total // 2) as flax takes it."""
    rng = np.random.RandomState(width)
    obs = rng.uniform(0, 1, (4, width + 2)).astype(np.float32)
    kw = dict(channels=(3, 5), kernel_size=kernel, stride=stride, hidden=8)
    jmod = jpolicy.ConvPolicy(vision_width=width, use_bf16=False, **kw)
    mod = policy.ConvPolicy(width + 2, width, use_bf16=False, **kw)
    params = jmod.init(jax.random.key(1), jnp.asarray(obs))
    mod.load_state_dict(policy.state_dict_from_flax(mod, _np(params)))
    with torch.no_grad():
        got = mod(torch.from_numpy(obs))[0].numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(params, jnp.asarray(obs))[0]),
                               rtol=1e-5, atol=1e-6)


def test_conv_policy_shape_errors():
    """An observation narrower than the eye line is refused, by the
    constructor and by the forward, with the JAX message."""
    with pytest.raises(ValueError, match="obs width 10 < vision_width 16"):
        policy.ConvPolicy(10, 16)
    with pytest.raises(ValueError, match="obs width 10 < vision_width 16"):
        jpolicy.ConvPolicy(vision_width=16).init(jax.random.key(0), jnp.zeros((1, 10)))
    mod = policy.ConvPolicy(OBS, W)
    with pytest.raises(ValueError, match="obs width 10 < vision_width 16"):
        mod(torch.zeros(2, 10))


def test_conv_policy_uses_spatial_structure():
    """Every conv and dense parameter gets gradient, and shifting a bright
    pixel along the line changes the action while the ego features stay
    (tests/test_conv_policy.py::test_conv_policy_uses_spatial_structure)."""
    mod = policy.ConvPolicy(OBS, W, channels=(4, 8), hidden=16, use_bf16=False)
    obs = torch.zeros(1, OBS)
    obs[0, 3] = 1.0
    (mod(obs)[0] ** 2).sum().backward()
    grads = {k: p.grad for k, p in mod.named_parameters() if k != "log_std"}
    assert all(g is not None and g.abs().sum() > 0 for g in grads.values()), grads.keys()
    shifted = torch.zeros(1, OBS)
    shifted[0, 9] = 1.0
    with torch.no_grad():
        assert not torch.allclose(mod(obs)[0], mod(shifted)[0])


def test_conv_backward_matches_autograd():
    """_Conv1dNoTF32's hand-written backward (aten.convolution_backward
    under TF32-off flags) equals autograd through F.conv1d, in float64."""
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(6, 3, 19), requires_grad=True)
    w = torch.tensor(rng.randn(4, 3, 5), requires_grad=True)
    b = torch.tensor(rng.randn(4), requires_grad=True)
    assert torch.autograd.gradcheck(lambda x, w, b: policy._Conv1dNoTF32.apply(x, w, b, 2),
                                    (x, w, b))
    u = torch.tensor(rng.randn(6, 4, 8))
    got = torch.autograd.grad((policy._Conv1dNoTF32.apply(x, w, b, 2) * u).sum(), (x, w, b))
    want = torch.autograd.grad((torch.nn.functional.conv1d(x, w, b, 2) * u).sum(), (x, w, b))
    for g, h in zip(got, want):
        torch.testing.assert_close(g, h)


@pytest.mark.parametrize("use_bf16", [False, True])
def test_gru_policy_matches_flax_across_steps(use_bf16):
    """GRUPolicy against flax's over 5 steps of one carried state, from a
    zero carry: the encoder (bf16 when use_bf16), the cell and the head."""
    seq = np.stack([_obs((3, 4), 10 + t) for t in range(5)])
    jmod, params, mod = _crossed("GRUPolicy", use_bf16, seq[0], hidden=16)
    h_j, h = jmod.initial_carry((3, 4)), mod.initial_carry((3, 4), "cpu")
    assert h.shape == (3, 4, 16) and h.dtype == torch.float32 and not h.any()
    tol = dict(rtol=0, atol=2e-3) if use_bf16 else dict(rtol=1e-5, atol=1e-6)
    for obs in seq:
        h_j, (mean_j, log_std_j) = jmod.apply(params, h_j, jnp.asarray(obs))
        with torch.no_grad():
            h, (mean, log_std) = mod(h, torch.from_numpy(obs))
        np.testing.assert_allclose(h.numpy(), np.asarray(h_j), **tol)
        np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), **tol)
    np.testing.assert_array_equal(log_std.detach().numpy(), np.asarray(log_std_j))


def test_gru_carry_threading():
    """Step-by-step application equals the same loop restarted from a
    carried state: the carry is the only channel between steps; an
    unbatched carry and observation work too
    (tests/test_recurrent.py::test_gru_policy_shapes_and_carry_threading)."""
    mod = policy.GRUPolicy(OBS, hidden=16, use_bf16=False)
    seq = torch.from_numpy(np.stack([_obs((3,), 20 + t) for t in range(5)]))
    with torch.no_grad():
        h = mod.initial_carry((3,), "cpu")
        means = []
        for obs in seq:
            h, (mean, log_std) = mod(h, obs)
            means.append(mean)
        h2 = mod.initial_carry((3,), "cpu")
        for obs in seq[:2]:
            h2, _ = mod(h2, obs)
        for t, obs in enumerate(seq[2:], start=2):
            h2, (mean, _) = mod(h2, obs)
            torch.testing.assert_close(mean, means[t], rtol=0, atol=0)
        h1, (m1, _) = mod(mod.initial_carry((), "cpu"), seq[0, 1])
    assert mean.shape == (3, 2) and log_std.shape == (2,) and h.shape == (3, 16)
    torch.testing.assert_close(m1, means[0][1], rtol=1e-6, atol=1e-7)
    assert h1.shape == (16,)


def test_gru_gradient_reaches_back_in_time():
    """The action at step T depends on the observation at step 0 through
    the carry (nonzero gradient); an MLPPolicy's is exactly zero. The two
    biases flax's cell lacks (b_hr, b_hz) get no gradient, b_hn does
    (tests/test_recurrent.py::test_gru_gradient_reaches_back_in_time)."""
    mod = policy.GRUPolicy(6, hidden=8, use_bf16=False)
    mlp = policy.MLPPolicy(6, hidden=(8,), use_bf16=False)
    seq = torch.from_numpy(np.random.RandomState(6).randn(4, 6).astype(np.float32))
    for net, reaches in ((mod, True), (mlp, False)):
        obs0 = seq[0].clone().requires_grad_()
        h = mod.initial_carry((), "cpu")
        for t in range(4):
            if net is mod:
                h, (mean, _) = mod(h, obs0 if t == 0 else seq[t])
            else:
                mean, _ = mlp(obs0 if t == 0 else seq[t])
        mean.sum().backward()
        g = obs0.grad if obs0.grad is not None else torch.zeros(6)
        assert (g.abs().max().item() > 0) == reaches
    bias_hh = mod.cell.bias_hh.grad
    assert not bias_hh[:16].any() and bias_hh[16:].abs().max() > 0
    assert mod.cell.weight_hh.grad.abs().max() > 0


def test_inits_follow_flax():
    """The port's own inits have flax's statistics: lecun-normal conv
    kernels (fan_in = taps x channels), orthogonal recurrent kernels, zero
    biases, log_std -1."""
    torch.manual_seed(0)
    conv = policy.ConvPolicy(66, 64)
    w = conv.convs[1].weight
    assert abs(w.std().item() - (1 / (5 * 16)) ** 0.5) < 0.1 * (1 / 80) ** 0.5
    gru = policy.GRUPolicy(66, hidden=32)
    for w_h in gru.cell.weight_hh.detach().chunk(3):
        torch.testing.assert_close(w_h @ w_h.T, torch.eye(32), rtol=0, atol=1e-5)
    assert not gru.cell.bias_ih.any() and not gru.cell.bias_hh.any()
    for mod in (conv, gru):
        assert torch.equal(mod.log_std.detach(), torch.full((2,), -1.0))
    a = policy.seeded(3, lambda: policy.GRUPolicy(8, hidden=4))
    b = policy.seeded(3, lambda: policy.GRUPolicy(8, hidden=4))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))
