"""The plain reference against the program's parts, at small sizes on the CPU."""

from __future__ import annotations

import pytest
import torch

from benchmark.reference import actor_critic as ac
from benchmark.reference import ntuple, rules, search
from gym2048_tpu_torch.agents import expectimax
from gym2048_tpu_torch.core import rules as port_rules
from gym2048_tpu_torch.env import batched
from gym2048_tpu_torch.models import ntuple_big
from gym2048_tpu_torch.models.resnet import ActorCritic, boards_to_model_input

TUPLES = [list(t) for t in ntuple_big.LAYOUTS["4x6"]]


def boards(n: int, seed: int, top: int = 12) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    b = torch.randint(0, top, (n, 4, 4), generator=g).to(torch.int8)
    b[: n // 4] = torch.where(torch.rand((n // 4, 4, 4), generator=g) < 0.5, 0, b[: n // 4])
    b[-4:] = torch.tensor([[1, 2, 1, 2], [2, 1, 2, 1], [1, 2, 1, 2], [2, 1, 2, 17]])  # dead
    return b


def test_moves_and_spawns_are_the_programs():
    b = boards(4096, 1, top=18)
    for got, want in zip(rules.move_all(b), port_rules.move_all(b)):
        assert torch.equal(got.to(want.dtype), want)
    u = torch.rand((2, 4096), generator=torch.Generator().manual_seed(2))
    assert torch.equal(rules.spawn(b, u[0], u[1]), port_rules.spawn(b, u[0], u[1]))
    f = torch.rand((4096, 4), generator=torch.Generator().manual_seed(3))
    assert torch.equal(rules.fresh_boards(f), batched._fresh_boards(f))


@pytest.mark.parametrize("auto_reset", (True, False))
def test_env_step_is_the_programs(auto_reset):
    b = boards(2048, 4)
    n = b.shape[0]
    g = torch.Generator().manual_seed(5)
    action = torch.randint(0, 4, (n,), generator=g)
    u = torch.rand((n, 6), generator=g)
    score = torch.rand(n, generator=g) * 1000
    steps = torch.randint(0, 50, (n,), generator=g)
    state = batched.EnvState(b, score, torch.zeros(n, dtype=torch.bool), steps.to(torch.int32))
    nxt, ts = batched.step(state, action, batched.EnvConfig(auto_reset=auto_reset), u=u)
    got = rules.env_step(b, score, steps, action, u, auto_reset)
    assert torch.equal(got[0], nxt.board) and torch.equal(got[1], nxt.score)
    assert torch.equal(got[3], ts.reward) and torch.equal(got[4], ts.terminated)
    assert torch.equal(got[5].to(torch.int32), ts.highest)
    assert torch.equal(got[6], ts.score) and torch.equal(got[7].to(torch.int32), ts.steps)


def test_ntuple_values_are_the_programs():
    net = ntuple_big.NTupleNetwork(TUPLES, 4, (3, 4))
    ref = ntuple.Network(TUPLES, 4, [3, 4], torch.device("cpu"))
    assert ref.size == net.table_size
    table = torch.randn(net.table_size, generator=torch.Generator().manual_seed(6)) * 100
    b = boards(1024, 7, top=6)
    assert torch.equal(ref.indices(b), net.indices_batch(b).to(torch.int64))
    assert torch.equal(ref.values(table, b), net.value_batch(table, b))


def test_agent_values_and_moves_are_the_programs():
    net = ntuple_big.NTupleNetwork(TUPLES, 4, (3, 4))
    ref = ntuple.Network(TUPLES, 4, [3, 4], torch.device("cpu"))
    table = torch.randn(net.table_size, generator=torch.Generator().manual_seed(8)) * 100
    b = boards(24, 9, top=6)
    live = torch.ones(24, dtype=torch.bool)
    live[3] = False
    value = lambda x: ref.values(table, x)
    vf = lambda x: net.value_batch(table, x)
    for plies, beam in ((1, False), (2, False), (3, True)):
        assert torch.equal(search.move_values(value, b, plies, beam),
                           expectimax._afterstate_search(vf, b, plies, beam, map_spawn=False))
    q = search.adaptive_values(value, b, live, 4, 8)
    policy = expectimax.make_adaptive_policy(net.value_batch, 4, 8)
    assert torch.equal(q.argmax(-1).to(torch.int32), policy(table, b, live))


@pytest.mark.parametrize("train", (False, True))
def test_actor_critic_forward_is_the_programs(train):
    params, stats = ac.make_weights(8, 2, torch.Generator().manual_seed(10))
    model = ActorCritic(8, 2, torch.float32, "cpu", torch.Generator().manual_seed(0))
    leaves = dict(model.named_parameters())
    leaves.update(model.named_buffers())
    with torch.no_grad():
        for k, v in {**params, **stats}.items():
            leaves[k].copy_(v)
    model.train(train)
    b = boards(64, 11, top=17)
    logits, value = model(boards_to_model_input(b))
    ref_logits, ref_value = ac.forward(params, stats, b, 2, train)
    assert torch.allclose(logits, ref_logits, atol=1e-5, rtol=1e-5)
    assert torch.allclose(value, ref_value, atol=1e-5, rtol=1e-5)
    if train:  # the running statistics moved alike
        for k, v in stats.items():
            assert torch.allclose(leaves[k], v, atol=1e-6)
