"""AdamW of the port (``optim/adamw.py``) against the JAX package in
fp32, on the same seeded state and gradients.

Tolerances: ``schedule`` and ``clip_factor`` are bitwise equal. One
``adamw_leaf`` update is within 2 fp32 ulps of the reference's (rtol
2.4e-7 of each element's magnitude): both compute the same operations in
the same order, but XLA may contract a multiply and an add into one
fused multiply-add where PyTorch rounds twice. The port updates the
state in place, where the reference returns new arrays.
"""
import numpy as np
import pytest
import torch

from repro_torch.optim import adamw as tadamw

ULPS2 = 2.4e-7


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float32)
    got = got.numpy()
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= ULPS2 * np.abs(want) + 1e-30), \
        f"{what}: max rel err {np.max(err / (np.abs(want) + 1e-30))}"


def test_schedule_matches_reference():
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw
    for cfg in (tadamw.AdamWConfig(warmup_steps=5, total_steps=40),
                tadamw.AdamWConfig(warmup_steps=0, total_steps=1,
                                   lr=1e-3, min_lr_ratio=0.0)):
        jcfg = jadamw.AdamWConfig(**cfg.__dict__)
        for step in (0, 1, 4, 5, 6, 17, 39, 40, 100):
            want = np.float32(jadamw.schedule(jcfg, jnp.int32(step)))
            got = tadamw.schedule(cfg, step)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert np.float32(got) .view(np.int32) == want.view(np.int32), \
                (cfg, step, float(got), float(want))
            assert torch.equal(tadamw.schedule(cfg, torch.tensor(step)), got)


@pytest.mark.parametrize("wd_on", [True, False])
@pytest.mark.parametrize("step", [0, 3, 250])
def test_adamw_leaf_matches_reference(wd_on, step):
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw
    rng = np.random.RandomState(step + 10 * wd_on)
    shape = (33, 17)
    master = rng.randn(*shape).astype(np.float32)
    m = (rng.randn(*shape) * 1e-3).astype(np.float32)
    v = np.abs(rng.randn(*shape) * 1e-6).astype(np.float32)
    g = (rng.randn(*shape) * 1e-2).astype(np.float32)
    g[0, :4] = [0.0, 1e-30, -1e-30, 5.0]
    cfg = tadamw.AdamWConfig()
    jcfg = jadamw.AdamWConfig()
    lr = np.float32(2.5e-4)
    want = jadamw.adamw_leaf(
        {"master": jnp.asarray(master), "m": jnp.asarray(m),
         "v": jnp.asarray(v)}, jnp.asarray(g), lr=jnp.float32(lr), cfg=jcfg,
        step=jnp.int32(step), wd_on=wd_on)
    state = {"master": torch.from_numpy(master.copy()),
             "m": torch.from_numpy(m.copy()),
             "v": torch.from_numpy(v.copy())}
    got = tadamw.adamw_leaf(state, torch.from_numpy(g),
                            lr=torch.tensor(lr), cfg=cfg, step=step,
                            wd_on=wd_on)
    for k in ("master", "m", "v"):
        _close(got[k], want[k], k)
        assert got[k] is state[k]          # updated in place


def test_clip_norm_and_masks_match_reference():
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw
    rng = np.random.RandomState(5)
    leaves = [rng.randn(7, 3).astype(np.float32), rng.randn(11)
              .astype(np.float32), (rng.randn(2, 2, 2) * 30)
              .astype(np.float32)]
    want = np.float32(jadamw.global_norm_sq_local(
        [jnp.asarray(x) for x in leaves]))
    got = tadamw.global_norm_sq_local([torch.from_numpy(x) for x in leaves])
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    for gn in (0.0, 1e-13, 0.5, 1.0, 1.0000001, 3.7, 1e9):
        w = np.float32(jadamw.clip_factor(jnp.float32(gn), 1.0))
        g = tadamw.clip_factor(torch.tensor(gn, dtype=torch.float32), 1.0)
        assert np.float32(g).view(np.int32) == w.view(np.int32), gn
    for shape in ((4,), (4, 4), (2, 3, 4)):
        x = np.zeros(shape, np.float32)
        assert tadamw.decay_mask(torch.from_numpy(x)) == \
            jadamw.decay_mask(jnp.asarray(x))
    st = tadamw.init_leaf_state(torch.ones(3))
    assert torch.equal(st["m"], torch.zeros(3)) and \
        torch.equal(st["v"], torch.zeros(3))
