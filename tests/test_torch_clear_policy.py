"""The clear policies of the port (``core/clear_policy.py``) against the JAX
package's, on the CPU (the plain versions of ``sat_add`` and
``sat_add_batch``).

For each policy the same updates go through the JAX policy's ``addto``
sequence and through the port's ``addto`` and ``addto_batch``: every
``read_and_clear`` must be equal, and so must the accumulator state and
``LazyClear``'s ``fallback_resets``. ``sat_add_batch`` is held against
the JAX *sequential* fold of ``ref.sat_add``, not against
``ops.sat_add_batch`` of the JAX package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core.clear_policy import make_clear_policy as jmake
from repro.kernels import ref as jref
from repro_torch.core.clear_policy import make_clear_policy as tmake
from repro_torch.kernels import ops
from repro_torch.kernels.constants import INT32_MAX, INT32_MIN, SAT_MAX

POLICIES = ("copy", "shadow", "lazy")


def _batches(rng, n=16):
    return [
        [rng.randint(-1000, 1000, n).astype(np.int32) for _ in range(5)],
        # saturating: two half-range updates overflow on the second one
        [np.full(n, SAT_MAX // 2 + 1, np.int32)] * 3,
        # sentinel inputs stay sticky through the fold
        [np.array([INT32_MAX, INT32_MIN, 5, -5] * (n // 4), np.int32),
         rng.randint(-10, 10, n).astype(np.int32)],
        # a lane that saturates mid-fold, then meets the other sentinel
        [np.array([SAT_MAX, -SAT_MAX, 7, 0] * (n // 4), np.int32),
         np.array([10, -10, -2 ** 31, 3] * (n // 4), np.int32),
         np.array([INT32_MIN, INT32_MAX, 1, 1] * (n // 4), np.int32)],
    ]


def _jax_state(pol):
    if hasattr(pol, "seg"):
        return [np.asarray(s) for s in pol.seg]
    return np.asarray(pol.acc)


def _torch_state(pol):
    if hasattr(pol, "seg"):
        return [s.numpy() for s in pol.seg]
    return pol.acc.numpy()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("batched", [False, True])
def test_policy_matches_jax_addto_sequence(policy, batched):
    rng = np.random.RandomState(7)
    jpol = jmake(policy, 16)
    tpol = tmake(policy, 16, device="cpu")
    for qs in _batches(rng):
        for q in qs:
            jpol.addto(jnp.asarray(q))
        if batched:
            tpol.addto_batch(list(qs))
        else:
            for q in qs:
                tpol.addto(q)
        np.testing.assert_array_equal(_torch_state(tpol), _jax_state(jpol))
        np.testing.assert_array_equal(tpol.read_and_clear().numpy(),
                                      np.asarray(jpol.read_and_clear()))
        np.testing.assert_array_equal(_torch_state(tpol), _jax_state(jpol))
        assert vars(tpol.stats) == vars(jpol.stats)
    if policy == "lazy":
        assert tpol.stats.fallback_resets == jpol.stats.fallback_resets > 0


def test_memory_multipliers_match_table6():
    for p, m in (("copy", 1), ("shadow", 2), ("lazy", 1)):
        assert tmake(p, 4, device="cpu").stats.memory_multiplier == m


def test_state_round_trip_starts_both_packages_alike():
    """A port policy restored from a state dict continues exactly like the
    JAX policy started from the same accumulator."""
    rng = np.random.RandomState(3)
    acc = rng.randint(-2 ** 30, 2 ** 30, 32).astype(np.int32)
    acc[:2] = [INT32_MAX, SAT_MAX - 5]
    tpol = tmake("lazy", 32, device="cpu")
    tpol.load_state({"acc": acc, "snapshot": acc // 2,
                     "stats": {"memory_multiplier": 1, "roundtrip_hops": 1,
                               "fallback_resets": 2}})
    jpol = jmake("lazy", 32)
    jpol.acc, jpol.snapshot = jnp.asarray(acc), jnp.asarray(acc // 2)
    jpol.stats.fallback_resets = 2
    q = rng.randint(-2 ** 30, 2 ** 30, 32).astype(np.int32)
    tpol.addto_batch([q, q])
    jpol.addto(jnp.asarray(q))
    jpol.addto(jnp.asarray(q))
    np.testing.assert_array_equal(tpol.read_and_clear().numpy(),
                                  np.asarray(jpol.read_and_clear()))
    state = tpol.state_dict()
    np.testing.assert_array_equal(state["acc"], np.asarray(jpol.acc))
    assert state["stats"]["fallback_resets"] == 3
    shadow = tmake("shadow", 4, device="cpu")
    shadow.addto(np.arange(4, dtype=np.int32))
    shadow.read_and_clear()
    again = tmake("shadow", 4, device="cpu")
    again.load_state(shadow.state_dict())
    assert again.active == 1 and again.state_dict()["seg"][0].tolist() == \
        [0, 1, 2, 3]


@settings(max_examples=25, deadline=None)
@given(st.lists(st.lists(st.integers(-2 ** 31, INT32_MAX),
                         min_size=4, max_size=4),
                min_size=1, max_size=6),
       st.lists(st.integers(-2 ** 31, INT32_MAX), min_size=4, max_size=4))
def test_sat_add_batch_equals_jax_sequential_fold(rows, acc):
    """ops.sat_add_batch == the JAX sequential ref.sat_add fold, exactly,
    over arbitrary int32 values: the reserved sentinels and -2**31
    included."""
    qs = np.array(rows, np.int32)
    acc = np.array(acc, np.int32)
    want = jnp.asarray(acc)
    for q in qs:
        want = jref.sat_add(want, jnp.asarray(q))
    got = ops.sat_add_batch(torch.from_numpy(acc), torch.from_numpy(qs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
