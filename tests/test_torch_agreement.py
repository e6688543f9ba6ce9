"""CntFwd of the port (``core/agreement.py``); mirrors
``test_agreement.py`` on the port's ``ServerAgent`` over a CPU switch,
runs the same vote sequence through the reference's, and checks the
on-device quorum gate on a gloo group of one rank."""
import numpy as np
import pytest
import torch

from repro_torch.core.agreement import (CntFwd, elastic_mean, quorum_commit,
                                        quorum_count)
from repro_torch.core.inc_map import ServerAgent, SwitchMemory


def make_server():
    return ServerAgent(SwitchMemory(2, 64, device="cpu"), gaid=1,
                       n_slots=16)


def test_threshold_forwarding():
    cf = CntFwd(server=make_server(), threshold=3)
    assert not cf.offer(7)
    assert not cf.offer(7)
    assert cf.offer(7)           # exactly at threshold: forward
    assert not cf.offer(7)       # already delivered


def test_test_and_set_lock():
    cf = CntFwd(server=make_server(), threshold=1)
    assert cf.test_and_set(5)    # first caller wins
    assert not cf.test_and_set(5)
    cf.release(5)
    assert cf.test_and_set(5)    # re-acquirable after release


def test_concurrent_ballots_independent():
    cf = CntFwd(server=make_server(), threshold=2)
    assert not cf.offer(1)
    assert not cf.offer(2)
    assert cf.offer(1)
    assert cf.offer(2)


def test_vote_weights():
    cf = CntFwd(server=make_server(), threshold=5)
    assert not cf.offer(9, votes=2)
    assert cf.offer(9, votes=3)


def test_vote_sequence_matches_reference():
    """A seeded mix of offers, test&sets and releases over 40 keys (more
    than the 16 mapped slots, so some counters spill to the host) gives
    the reference's answers and counters."""
    from repro.core import agreement as jagreement
    from repro.core import inc_map as jinc_map
    ref = jagreement.CntFwd(server=jinc_map.ServerAgent(
        jinc_map.SwitchMemory(2, 64), gaid=1, n_slots=16), threshold=3)
    port = CntFwd(server=make_server(), threshold=3)
    rng = np.random.RandomState(9)
    for _ in range(300):
        key, op = int(rng.randint(40)), rng.randint(4)
        if op < 2:
            votes = int(rng.randint(1, 3))
            assert port.offer(key, votes) == ref.offer(key, votes)
        elif op == 2:
            assert port.test_and_set(key) == ref.test_and_set(key)
        else:
            port.release(key)
            ref.release(key)
    assert port.delivered == ref.delivered
    for key in range(40):
        assert port.server.read(key) == ref.server.read(key)


@pytest.fixture
def one_rank():
    import torch.distributed as dist

    from repro_torch import compat
    from repro_torch.launch.mesh import one_rank_group
    with one_rank_group(torch.device("cpu")):
        yield compat.make_mesh((1,), ("data",), device="cpu") \
            .axes_of(("data",))
    assert not dist.is_initialized()


def test_on_device_quorum(one_rank):
    count = quorum_count(torch.tensor(1), one_rank)
    assert count.dtype == torch.int32 and int(count) == 1
    assert bool(quorum_commit(count, 1)) and not bool(quorum_commit(count, 2))
    x = torch.tensor([3.0, -6.0])
    assert torch.equal(elastic_mean(x, count), x)
    assert torch.equal(elastic_mean(x, torch.tensor(0)), x)
    assert torch.equal(elastic_mean(x, torch.tensor(3)),
                       torch.tensor([1.0, -2.0]))
