"""The fused BatchNorm layer's plain version
(``gym2048_tpu_torch.models.batch_norm``, ``y = relu(batch_norm(x) [+
residual])``), which the CPU runs, against the composition the models ran
before the layer held the add and the ReLU, against flax's ``nn.BatchNorm``
and ``nn.relu`` through the JAX package's own flax, and by its gradients.

Tolerances, with their reasons:

* Against the earlier composition: bit for bit (the same torch operations).
* Against flax, float32: within 1e-5 of the largest magnitude (flax's
  variance is ``E[x^2] - E[x]^2``, torch's two-pass; sums in their own
  orders). bfloat16: within 2^-7 of the largest magnitude, where both round
  the normalised value and the sum to bfloat16 (a rounding apart at most).
* Gradients: ``torch.autograd.gradcheck`` in float64; against autograd of
  the composed operations bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from gym2048_tpu_torch.models import batch_norm as bn
from gym2048_tpu_torch.models import resnet
from gym2048_tpu_torch.train import ppo
from gym2048_tpu_torch.utils import graphs

EPS, MOMENTUM = 1e-5, 0.01
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
JDTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}
CASES = [(mode, residual, c, dtype) for mode in ("train", "eval") for residual in (False, True)
         for c in (2, 64) for dtype in DTYPES]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def layer(c: int, seed: int, dtype=torch.float32) -> resnet.BatchNorm:
    """A BatchNorm of ``c`` channels with its scale, bias and running
    statistics drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    m = resnet.BatchNorm(c, device="cpu").to(dtype)
    with torch.no_grad():
        m.weight.uniform_(0.5, 1.5, generator=g)
        m.bias.uniform_(-0.5, 0.5, generator=g)
        m.running_mean.normal_(generator=g)
        m.running_var.uniform_(0.5, 1.5, generator=g)
    return m


def activations(n: int, c: int, dtype, seed: int) -> torch.Tensor:
    """``(n, c, 4, 4)`` channels-last activations (the models' layout)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 4, 4, c, generator=g, dtype=torch.float64) * 2 + 0.5
    return x.to(dtype).permute(0, 3, 1, 2)


def composed(m: resnet.BatchNorm, x, residual):
    """What the models computed before the layer held the ReLU and the add:
    ``BatchNorm.forward`` as it was, the add and ``F.relu``."""
    if m.training:
        out, mean, invstd = torch.native_batch_norm(x, m.weight, m.bias, None, None, True, 0.0,
                                                    m.eps)
        with torch.no_grad():
            m.running_mean.lerp_(mean, 0.01)
            m.running_var.lerp_(invstd.pow(-2).sub_(m.eps).clamp_min_(0.0), 0.01)
    else:
        out = F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps)
    return F.relu(out if residual is None else out + residual)


@pytest.mark.parametrize("mode, residual, c, dtype", CASES)
def test_plain_forward_and_statistics_equal_the_composition(mode, residual, c, dtype):
    """The layer on the CPU is the earlier composition, output and running
    statistics bit for bit; it launches nothing."""
    dt = DTYPES[dtype]
    a, b = layer(c, c).train(mode == "train"), layer(c, c).train(mode == "train")
    x = activations(48, c, dt, 1)
    res = activations(48, c, dt, 2) if residual else None
    launches = dict(bn.LAUNCHES)
    got = a(x, res)
    assert bn.LAUNCHES == launches
    assert got.dtype == dt and torch.equal(got, composed(b, x, res))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k


@pytest.mark.parametrize("mode, residual, c, dtype", CASES)
def test_plain_forward_and_statistics_match_flax(mode, residual, c, dtype):
    """flax's ``nn.BatchNorm`` (momentum 0.99, epsilon 1e-5, the cell's
    dtype), the add and ``nn.relu`` on the same NHWC data: the output and
    the new running statistics."""
    dt, jdt = DTYPES[dtype], JDTYPES[dtype]
    m = layer(c, c + 1).train(mode == "train")
    x = activations(40, c, dt, 3)
    res = activations(40, c, dt, 4) if residual else None
    variables = {"params": {"scale": m.weight.detach().numpy(), "bias": m.bias.detach().numpy()},
                 "batch_stats": {"mean": m.running_mean.numpy().copy(),
                                 "var": m.running_var.numpy().copy()}}
    nhwc = jnp.asarray(x.permute(0, 2, 3, 1).float().numpy()).astype(jdt)
    flax_bn = fnn.BatchNorm(use_running_average=mode == "eval", momentum=0.99, epsilon=EPS,
                            dtype=jdt)
    out, new = flax_bn.apply(variables, nhwc, mutable=["batch_stats"])
    if residual:
        out = out + jnp.asarray(res.permute(0, 2, 3, 1).float().numpy()).astype(jdt)
    want = np.asarray(jax.nn.relu(out).astype(jnp.float32))
    with torch.no_grad():
        got = m(x, res).permute(0, 2, 3, 1).float().numpy()
    scale = max(1.0, np.abs(want).max())
    limit = (1e-5 if dt == torch.float32 else 2.0 ** -7) * scale
    assert np.abs(got - want).max() <= limit
    for name, buf in (("mean", m.running_mean), ("var", m.running_var)):
        w = np.asarray(new["batch_stats"][name])
        assert np.abs(buf.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), name


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("residual", [False, True])
def test_plain_backward_gradcheck(mode, residual):
    """The plain version's gradients with respect to x, the scale, the bias
    and the residual, by finite differences in float64 (train mode's
    running statistics are buffers, not inputs)."""
    m = layer(3, 5, torch.float64).train(mode == "train")
    x = activations(2, 3, torch.float64, 6).requires_grad_()
    res = activations(2, 3, torch.float64, 7).requires_grad_() if residual else None
    w, b = m.weight.detach().clone().requires_grad_(), m.bias.detach().clone().requires_grad_()

    def fn(x, w, b, *res):
        return bn.batch_norm_relu_reference(x, w, b, m.running_mean.clone(),
                                            m.running_var.clone(), *res, mode == "train",
                                            MOMENTUM, EPS)

    assert torch.autograd.gradcheck(fn, (x, w, b, *([res] if residual else [])))


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_backward_equals_autograd_of_the_composed_ops(mode, residual, dtype):
    """The layer's gradients (x, scale, bias, residual) are autograd's of
    ``F.batch_norm``, the add and ``F.relu``, bit for bit."""
    dt = DTYPES[dtype]
    grads = []
    for fused in (True, False):
        m = layer(64, 8).train(mode == "train")
        x = activations(32, 64, dt, 9).requires_grad_()
        res = activations(32, 64, dt, 10).requires_grad_() if residual else None
        if fused:
            y = m(x, res)
        else:
            z = F.batch_norm(x, None if m.training else m.running_mean,
                             None if m.training else m.running_var, m.weight, m.bias,
                             m.training, 0.0, EPS)
            y = F.relu(z if res is None else z + res)
        y.backward(activations(32, 64, dt, 11))
        grads.append([x.grad, m.weight.grad, m.bias.grad] + ([res.grad] if residual else []))
    for got, want in zip(*grads, strict=True):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_running_statistics_follow_flax_rule(dtype):
    """Three train-mode steps: each moves the running statistics by 0.01
    towards the batch's mean and biased variance (``torch.var_mean``'s with
    ``correction=0``, within 1e-6 of their magnitude); a constant channel's
    variance adds 0, so its running variance keeps 0.99 of itself."""
    m = layer(16, 12).train()
    for step in range(3):
        x = activations(64, 16, DTYPES[dtype], 13 + step).clone()
        x[:, 5] = 0.25
        mean_before, var_before = m.running_mean.clone(), m.running_var.clone()
        m(x)
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        for got, want in ((m.running_mean, mean_before.lerp(mean, 0.01)),
                          (m.running_var, var_before.lerp(var, 0.01))):
            assert (got - want).abs().max() <= 1e-6 * max(1.0, want.abs().max())
        assert m.running_var[5] == pytest.approx(0.99 * var_before[5].item(), abs=1e-7)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sgd_steps_through_graphed_step_plain_calls_equal_eager(dtype):
    """A PPO iteration of three SGD steps with the buffered step (two
    warm-ups, then one plain call of ``GraphedStep.replay`` off the card)
    and with the eager step: metrics, parameters, running statistics and
    Adam's state equal bit for bit, in the compute dtype."""
    states = []
    for graph in (False, True):
        tr = ppo.PPO(ppo.PPOConfig(n_envs=8, n_steps=4, batch_size=32, n_epochs=graphs.WARMUP + 1,
                                   filters=8, residual_blocks=1, seed=2,
                                   compute_dtype=DTYPES[dtype]), device="cpu")
        tr.graph_sgd = graph
        state = tr.init_state()
        state, metrics = tr.train_iteration(state)
        if graph:
            assert tr._sgd_graph.graphed.warm == graphs.WARMUP
        states.append((state, metrics))
    (a, ma), (b, mb) = states
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict()["adam"]["state"], b.optimizer.state_dict()["adam"]["state"]
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])


@pytest.mark.parametrize("bad", ["dtype", "rank", "weight", "residual", "device"])
def test_arguments_the_layer_does_not_take_raise(bad):
    """float16, a 3-D input, a weight of another width, a residual of
    another shape, a device with no kernel: each a ValueError."""
    m = layer(8, 14)
    x = activations(4, 8, torch.float32, 15)
    args = [x, m.weight, m.bias, m.running_mean, m.running_var, None]
    if bad == "dtype":
        args[0] = x.half()
    elif bad == "rank":
        args[0] = x[0]
    elif bad == "weight":
        args[1] = torch.ones(7)
    elif bad == "residual":
        args[5] = x[:2]
    else:
        args = [torch.empty(t.shape, dtype=t.dtype, device="meta") if t is not None else None
                for t in args]
    with pytest.raises(ValueError):
        bn.batch_norm_relu(*args)
