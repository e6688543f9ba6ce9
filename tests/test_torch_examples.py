"""The paper's applications on the port (``repro_torch.examples``) against
the reference's ``examples/`` on the CPU.

Each reference example's ``main()`` returns nothing, so it runs under
``capsys`` and its printed lines are parsed; where a value is not printed
but asserted by the example itself (the reduced dict of mapreduce, one
commit per ballot in paxos, train_telemetry's mid-run read and fold
count), its ``main`` returning is the proof of that value. The port's
``main(device="cpu")`` returns what it asserts and prints, and its printed
lines equal the reference's, letter for letter, once the timings are
masked.

What is held, and how (``repro_torch.examples.hold``, the rule that
``chip_smoke.py`` phase s1 applies too):

- exactly: mapreduce's reduced dict and top 5; monitoring's counts (equal
  to the truth of the seeded traffic), hot flows, ``capacity``,
  ``drained_calls`` (201) and probe counter; paxos's one commit per
  ballot and the learner's 50 messages; train_telemetry's sums, mid-run
  read and ``local_folds``, and ``inc_local_folds_total == local_folds -
  flushes``;
- host speed: monitoring's service keeps the reference's
  ``DrainPolicy(max_batch=16, max_delay=0.05, eager_window=False)`` and
  TrainTelemetry its ``max_delay=0.25``, so a slow host can cut a batch
  (or seal a fold) by time. Monitoring's ``cache_hit_ratio``,
  ``drained_batches`` and ``drains`` and train_telemetry's ``flushes`` are
  held to the reference only where both runs show ``drains['time'] ==
  0`` (batches cut by size and demand alone); otherwise each run keeps
  the reference's own invariants (counts exact, ``0 < flushes < 32``,
  ``traffic_reduction > 1.5``). The reference's train_telemetry prints
  no drain triggers, so its run's are read from the
  ``scheduling_report()`` its ``main`` asks for (a wrapper that records
  the report and returns it unchanged). No service class, compiled
  schema or policy of either package is touched;
- never: wall times, throughput, latency quantiles and the number of
  trace events (a process-wide batch counter picks the traced batches).

train_mini: the port's ``hundred_m_config()`` is the reference's field by
field (28 326 400 parameters in both); a 3-step run of its ``main`` at 2
layers matches the reference's ``train_loop`` on the same 2-layer config
at the loss tolerance of ``test_torch_train.py`` (rtol 2e-4 at each step;
measured 6.1e-5 at most). The two packages draw their own weights and
their own bigram tokens, so the port's run takes the reference's initial
params and optimizer state and its tokens of each step (its
``steps.init_state`` and ``pipeline.make_batch`` fed those). The
reference's mesh takes ``model_axis=1`` (its default of 2 is cut to the
one JAX CPU device anyway).

The CUDA lane (marker ``cuda``) runs mapreduce, monitoring, paxos and
train_telemetry on the card against the same examples on the CPU, by the
same rules; it imports no JAX.
"""
import ast
import importlib
import re
import sys
from collections import Counter
from dataclasses import asdict, replace

import numpy as np
import pytest
import torch

import repro_torch.configs.base as B
from repro_torch import obs
from repro_torch.examples import (hold, mapreduce, monitoring, paxos,
                                  train_mini, train_telemetry)
from repro_torch.kernels import ops

EXAMPLES = {"mapreduce": mapreduce, "monitoring": monitoring,
            "paxos": paxos, "train_telemetry": train_telemetry,
            "train_mini": train_mini}
RUNTIME = ("mapreduce", "monitoring", "paxos", "train_telemetry")
LOSS_RTOL = 2e-4        # test_torch_train.py's loss tolerance

# wall times and the trace's length: printed, never compared
TIMINGS = (r"\d+ proposals/s", r"latency \d+us", r"p99 \d+us",
           r"p50=[\d.]+us", r"p99=[\d.]+us", r"\d+ trace events")
# what a batch cut by time moves
HOST_SPEED = {"monitoring": (r"cache hit ratio: [\d.]+", r"CHR=[\d.]+",
                             r"in \d+ batches \(triggers \{[^}]*\}\), "
                             r"mean batch [\d.]+"),
              "train_telemetry": (r"-> \d+ switch updates \(.*\)",)}


def _truth() -> dict:
    """The flow counts of monitoring's seeded zipf traffic."""
    rng = np.random.RandomState(0)
    truth = Counter()
    for _ in range(200):
        truth.update(f"flow-{f}" for f in rng.zipf(1.4, 64) % 2000)
    return dict(truth)


@pytest.fixture(autouse=True)
def clean_obs():
    """Each package's obs off and empty after a test, whatever it raised."""
    yield
    obs.disable()
    obs.reset()
    ref = sys.modules.get("repro.obs")
    if ref is not None:
        ref.disable()
        ref.reset()


@pytest.fixture
def port_registry(monkeypatch):
    """The port's config registry as a copy, so ``mini-100m`` leaves with
    the test."""
    B.list_archs()
    monkeypatch.setattr(B, "_REGISTRY", dict(B._REGISTRY))


def _mask(text: str, name: str, host_speed: bool) -> list[str]:
    pats = TIMINGS + (HOST_SPEED.get(name, ()) if host_speed else ())
    for p in pats:
        text = re.sub(p, "<masked>", text)
    return text.splitlines()


def _by_time(a: dict, b: dict) -> bool:
    """Whether either run cut a batch by time."""
    return bool(a["drains"]["time"] or b["drains"]["time"])


def _reference(name: str, monkeypatch, capsys) -> tuple[dict, str]:
    """The reference example's ``main()`` (argv empty); returns what its
    printed lines and its own asserts establish, and its stdout."""
    ref = importlib.import_module(f"examples.{name}")
    monkeypatch.setattr(sys, "argv", [name])
    reports = []
    if name == "train_telemetry":
        from repro.core.runtime import IncRuntime
        report = IncRuntime.scheduling_report

        def recorded(self):
            reports.append(report(self))
            return reports[-1]
        monkeypatch.setattr(IncRuntime, "scheduling_report", recorded)
    capsys.readouterr()
    ref.main()
    out = capsys.readouterr().out
    line = {ln.split(":", 1)[0]: ln for ln in out.splitlines()}
    if name == "mapreduce":
        truth = Counter(w for s in ref.CORPUS for w in s.split())
        return {"counts": dict(truth),      # asserted by its main
                "top": ast.literal_eval(line["top words"].split(": ", 1)[1])
                }, out
    if name == "paxos":
        m = re.search(r"learner saw (\d+) messages", out)
        # one commit a ballot: asserted by its main
        return {"commits": [1] * 50, "learned": int(m.group(1))}, out
    if name == "train_telemetry":
        m = re.search(r"(\d+) metric pushes -> (\d+) switch updates "
                      r"\(local_accum=\d+, traffic reduction ([\d.]+)x, "
                      r"(\d+) traversals saved\)", out)
        sums = re.findall(r"(\w+)=([\d.]+)", line["sums exact at "
                                                "precision=3"].split(": ")[1])
        sched = reports[0]["train-metrics"]
        return {"sums": {k: float(v) for k, v in sums},
                "mid": {"tokens": 30 * 4096.0},    # asserted by its main
                "local_folds": int(m.group(1)),    # == 32, asserted
                "flushes": int(m.group(2)),
                "traffic_reduction": float(m.group(3)),
                "inc_local_folds_total": int(m.group(4)),
                "drains": sched["drains"]}, out
    if name == "monitoring":
        flows = re.search(r"flows tracked: (\d+); switch slots: (\d+); "
                          r"cache hit ratio: ([\d.]+)", out)
        drain = re.search(r"auto-drain: (\d+) calls in (\d+) batches "
                          r"\(triggers (\{[^}]*\})\), mean batch ([\d.]+)",
                          out)
        assert int(flows.group(1)) == len(_truth())
        return {"counts": _truth(),                # asserted by its main
                "truth": _truth(),
                "hot": ast.literal_eval(line["hot flows"].split(": ", 1)[1]),
                "capacity": int(flows.group(2)),
                "cache_hit_ratio": float(flows.group(3)),
                "drained_calls": int(drain.group(1)),
                "drained_batches": int(drain.group(2)),
                "drains": ast.literal_eval(drain.group(3)),
                "mean_drained_batch": float(drain.group(4)),
                "probes": int(re.search(r"obs: (\d+) probes",
                                        out).group(1))}, out
    raise KeyError(name)


@pytest.mark.parametrize("name", RUNTIME)
def test_example_matches_reference(name, monkeypatch, capsys):
    """The port's example on the CPU against the reference's: the values
    by ``hold``, the printed lines letter for letter (timings masked;
    what a batch cut by time moves, masked only where one was)."""
    capsys.readouterr()
    got = EXAMPLES[name].main(device="cpu")
    got_out = capsys.readouterr().out
    want, want_out = _reference(name, monkeypatch, capsys)
    if name == "monitoring":        # as the reference prints it
        got = dict(got, cache_hit_ratio=round(got["cache_hit_ratio"], 3))
    hold(name, got, want)
    by_time = "drains" in got and _by_time(got, want)
    assert _mask(got_out, name, by_time) == _mask(want_out, name, by_time)


def test_monitoring_keeps_the_reference_policy():
    """The Monitor service's compiled schema drains as the reference's:
    ``DrainPolicy(max_batch=16, max_delay=0.05, eager_window=False)``."""
    from examples.monitoring import Monitor as RefMonitor
    port = monitoring.Monitor.__inc_schema__.channel_policies["MON-1"]
    ref = RefMonitor.__inc_schema__.channel_policies["MON-1"]
    assert asdict(port) == asdict(ref)
    assert (port.max_batch, port.max_delay, port.eager_window) == \
        (16, 0.05, False)


def test_examples_leave_obs_off():
    """monitoring and train_telemetry turn obs on and leave it off and
    empty, as the reference's do."""
    for mod in (monitoring, train_telemetry):
        mod.main(device="cpu")
        assert not obs.enabled()
        assert obs.registry().snapshot()["counters"] == {}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_needs_the_card(name, port_registry):
    """Without a card and without ``device``, every example raises before
    it touches a process-wide state (obs, the config registry)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EXAMPLES[name].main()
    assert not obs.enabled()
    assert "mini-100m" not in B._REGISTRY


# -- train_mini ---------------------------------------------------------------

def test_hundred_m_config_matches_reference():
    from examples.train_mini import hundred_m_config as ref_config
    from repro.models import api as ref_api

    from repro_torch.models import api
    assert asdict(train_mini.hundred_m_config()) == asdict(ref_config())
    assert api.count_params(train_mini.hundred_m_config()) == \
        ref_api.count_params(ref_config()) == 28_326_400


def test_train_mini_matches_reference_train_loop(monkeypatch, port_registry):
    """``main(--steps 3 --layers 2)`` on the CPU against the reference's
    ``train_loop`` on the same 2-layer config (B = 16, S = 128, netrpc,
    one microbatch), from the reference's initial state and tokens: the
    loss of each step within rtol 2e-4."""
    import jax

    import repro.configs.base as RB
    from examples.train_mini import hundred_m_config as ref_config
    from repro.data import pipeline as ref_pipeline
    from repro.launch import steps as ref_steps
    from repro.launch.train import train_loop as ref_train_loop

    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models import api
    cfg = replace(ref_config(), n_layers=2,
                  pattern_groups=((("global",), 2),))
    RB.get_arch("qwen2.5-3b")           # the registry populated first
    monkeypatch.setitem(RB._REGISTRY, "mini-100m",
                        replace(cfg, name="mini-100m"))
    start = {}
    init_state = ref_steps.init_state

    def recorded(prog, cfg, *a, **kw):
        params, opt = init_state(prog, cfg, *a, **kw)
        start["params"] = jax.tree.map(np.asarray, params)
        start["opt"] = jax.tree.map(np.asarray, opt)
        return params, opt
    monkeypatch.setattr(ref_steps, "init_state", recorded)
    want = ref_train_loop(arch="mini-100m", inc_mode="netrpc", steps_n=3,
                          seq=128, batch=16, reduced=False,
                          data_kind="bigram", n_micro=1, model_axis=1)
    dcfg = ref_pipeline.DataConfig(vocab=cfg.vocab, batch=16, seq_len=128,
                                   kind="bigram")
    tokens = [np.array(ref_pipeline.make_batch(dcfg, s)["tokens"])
              for s in range(3)]
    monkeypatch.setattr(steps, "init_state", lambda prog, cfg, seed=0: (
        api.params_from_jax(start["params"], "cpu"),
        api.opt_from_jax(start["opt"], "cpu")))
    monkeypatch.setattr(pipeline, "make_batch", lambda dcfg, s: {
        "tokens": torch.from_numpy(tokens[s])})
    got = train_mini.main(["--steps", "3", "--layers", "2"], device="cpu")
    assert asdict(B._REGISTRY["mini-100m"]) == \
        asdict(replace(cfg, name="mini-100m"))
    assert got["params"] == api.count_params(cfg)
    assert got["gap"] is None and got["compare"] is None
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)


def test_train_mini_main_runs_twice_in_one_process(port_registry):
    """A second ``main`` in one process re-registers ``mini-100m`` and
    runs the same steps again; ``--compare`` adds the xla-psum run and
    reports the final-loss gap."""
    first = train_mini.main(["--steps", "2", "--layers", "1"], device="cpu")
    again = train_mini.main(["--steps", "2", "--layers", "1", "--compare"],
                            device="cpu")
    assert B._REGISTRY["mini-100m"].n_layers == 1
    assert again["losses"] == first["losses"]
    assert all(np.isfinite(first["losses"]))
    psum = again["compare"]["losses"]
    assert len(psum) == 2 and all(np.isfinite(psum))
    assert again["gap"] == abs(first["losses"][-1] - psum[-1])
    assert first["entropy_floor"] < first["losses"][-1]


# -- CUDA lane ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", RUNTIME)
def test_cuda_example_matches_cpu(cuda, name):
    """The example on the card (the default device) equals the same
    example on the CPU by ``hold``; its INC map launched sparse_addto
    (kernel 4) and no plain version."""
    ops.reset_counts()
    card = EXAMPLES[name].main()
    torch.cuda.synchronize()
    launches, plain = ops.launch_counts(), ops.plain_counts()
    assert launches["sparse_addto"] > 0, launches
    assert not any(plain.values()), plain
    hold(name, card, EXAMPLES[name].main(device="cpu"))
