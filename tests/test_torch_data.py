"""The port's synthetic data pipeline (``data/pipeline.py``); mirrors
``test_data.py``.

The port draws from ``torch.Generator``s, which cannot reproduce
``jax.random``: its tokens and its transition table differ from the
reference's. So the mirrors hold the port to the same properties, and
the comparisons with the JAX package pass the reference's transition
table across (``logits=``): the entropy of one table is the same number
in both packages (rtol 1e-5: a sum of 64 fp32 terms in another order),
and the port's chain follows the reference's table.
"""
from collections import Counter

import numpy as np
import torch

from repro_torch.data import pipeline


def cfg(kind="bigram"):
    return pipeline.DataConfig(vocab=64, batch=4, seq_len=16, seed=7,
                               kind=kind)


def test_restart_determinism():
    for kind in ("bigram", "uniform"):
        a = pipeline.make_batch(cfg(kind), 5)["tokens"]
        b = pipeline.make_batch(cfg(kind), 5)["tokens"]
        assert torch.equal(a, b)


def test_steps_differ():
    a = pipeline.make_batch(cfg(), 1)["tokens"]
    b = pipeline.make_batch(cfg(), 2)["tokens"]
    assert not torch.equal(a, b)


def test_shapes_and_range():
    for kind in ("bigram", "uniform"):
        t = pipeline.make_batch(cfg(kind), 0)["tokens"]
        assert tuple(t.shape) == (4, 17) and t.dtype == torch.int32
        assert int(t.min()) >= 0 and int(t.max()) < 64


def test_bigram_entropy_below_uniform():
    h = pipeline.bigram_entropy(cfg())
    assert 0 < h < np.log(64)          # learnable structure exists


def _transitions_from(toks: np.ndarray, a: int, vocab: int):
    pairs = [(x, y) for row in toks for x, y in zip(row[:-1], row[1:])]
    cnt = Counter(y for x, y in pairs if x == a)
    n = sum(cnt.values())
    return n, np.array([cnt.get(i, 0) / max(n, 1) for i in range(vocab)])


def test_bigram_statistics_match_chain():
    """Empirical next-token distribution tracks the transition matrix."""
    c = pipeline.DataConfig(vocab=8, batch=64, seq_len=64, seed=3,
                            kind="bigram")
    trans = torch.softmax(pipeline.transition_logits(c), dim=-1).numpy()
    toks = pipeline.make_batch(c, 0)["tokens"].numpy()
    n, emp = _transitions_from(toks, 0, 8)
    assert n > 100
    np.testing.assert_allclose(emp, trans[0], atol=0.15)


def test_reference_table_across():
    """The reference's transition logits, passed to the port: the same
    entropy, and the port's chain follows that table."""
    import jax

    from repro.data import pipeline as jpipeline
    jc = jpipeline.DataConfig(vocab=8, batch=64, seq_len=64, seed=3,
                              kind="bigram")
    logits = np.array(jpipeline._transition_logits(jc))
    c = pipeline.DataConfig(vocab=8, batch=64, seq_len=64, seed=3)
    got = pipeline.bigram_entropy(c, logits=torch.from_numpy(logits))
    np.testing.assert_allclose(got, jpipeline.bigram_entropy(jc), rtol=1e-5)
    toks = pipeline.make_batch(c, 0, logits=torch.from_numpy(logits))
    trans = np.asarray(jax.nn.softmax(logits, axis=-1))
    for a in range(3):
        n, emp = _transitions_from(toks["tokens"].numpy(), a, 8)
        assert n > 100
        np.testing.assert_allclose(emp, trans[a], atol=0.15)


def test_defaults_stubs_and_placement():
    """``bigram`` is the default, as in the reference; a text model gets
    no modality stubs; a VLM gets bf16 patches; shard_batch places the
    batch on the device."""
    from repro_torch.configs.base import get_arch
    assert pipeline.DataConfig(vocab=8, batch=1, seq_len=1).kind == "bigram"
    assert pipeline.DataConfig(vocab=8, batch=1, seq_len=1) \
        .temperature == 0.7
    b = pipeline.make_batch(cfg(), 0)
    qwen = get_arch("qwen2.5-3b").reduced()
    assert set(pipeline.add_modality_stubs(dict(b), qwen, 4)) == {"tokens"}
    vlm = get_arch("llama-3.2-vision-90b").reduced()
    stub = pipeline.add_modality_stubs(dict(b), vlm, 4)
    assert stub["patches"].shape == (4, vlm.frontend_tokens, vlm.d_model)
    assert stub["patches"].dtype == torch.bfloat16
    placed = pipeline.shard_batch(b, "cpu")
    assert placed["tokens"].device.type == "cpu"
    assert torch.equal(placed["tokens"], b["tokens"])


def test_transition_probs_drawn_once_a_chain(monkeypatch):
    """``make_batch`` takes the chain's softmax from a cache, once a chain
    and not once a batch (67 M elements at vocab 8 192), and draws the
    tokens it drew from a softmax taken afresh."""
    c = pipeline.DataConfig(vocab=32, batch=3, seq_len=9, seed=11)
    fresh = [pipeline.make_batch(c, s, logits=pipeline.transition_logits(c))
             ["tokens"] for s in range(3)]
    calls = []
    softmax = torch.softmax

    def counted(*a, **kw):
        calls.append(1)
        return softmax(*a, **kw)
    monkeypatch.setattr(torch, "softmax", counted)
    pipeline.transition_probs.cache_clear()
    got = [pipeline.make_batch(c, s)["tokens"] for s in range(3)]
    assert len(calls) == 1
    for a, b in zip(got, fresh):
        assert torch.equal(a, b)
