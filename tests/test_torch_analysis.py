"""planelint for the port (repro_torch.analysis).

The 46 tests of ``tests/test_analysis.py`` mirrored on the port's
analyzer: per-rule fires/doesn't-fire fixtures (paths under
``src/repro_torch/``, obs imports from ``repro_torch.obs``),
pragma/baseline round-trips, the tree gate over ``src/repro_torch``
against ``scripts/planelint_torch_baseline.json``, the zero-dependency
guarantee, and the PLANE_LOCK_TIMEOUT regressions against
``repro_torch.core.rpc`` on the CPU.

Then the differential against ``repro.analysis`` (stdlib-only too): every
fixture gives the same (rule, line, scope, detail, message) under both
analyzers, the reference reading it at ``src/repro/<x>`` with
``repro.obs`` imports; and the four places where the reference's
analyzer is blind to the port's idiom give the expected finding under
the port's and none under the reference's.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

import repro.analysis as ref_planelint
from repro.analysis.cli import main as ref_cli_main
from repro_torch.analysis import analyze_paths, analyze_source, baseline, run
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.rules import RULES

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src" / "repro_torch"
BASELINE = REPO / "scripts" / "planelint_torch_baseline.json"

FIXTURE = "src/repro_torch/fixture.py"
HOT = "src/repro_torch/core/inc_map.py"     # a hot-path filename for O1


def findings(source, rule=None, path=FIXTURE):
    got = analyze_source(textwrap.dedent(source), path=path)
    if rule is not None:
        got = [f for f in got if f.rule == rule]
    return got


def rules_of(source, path=FIXTURE):
    return {f.rule for f in findings(source, path=path)}


def _as_reference(source, path):
    """The fixture as the reference's test file writes it."""
    return (source.replace("repro_torch.obs", "repro.obs"),
            path.replace("src/repro_torch/", "src/repro/"))


def _rows(got):
    return sorted((f.rule, f.line, f.scope, f.detail, f.message)
                  for f in got)


# ---------------------------------------------------------------------------
# L1 — stripe-locked state

L1_BAD = """
    def promote(segments):
        for seg in segments:
            seg.regs = seg.regs + 1
"""

L1_GOOD = """
    def promote(segments):
        for seg in segments:
            with seg.lock:
                seg.regs = seg.regs + 1
"""

L1_EXEMPT = """
    class Agent:
        def __init__(self):
            self.mapping = {}
        @_locked
        def install(self, k, v):
            self.mapping[k] = v
        def _install(self, k, v):
            self.mapping[k] = v
"""

L1_PUBLIC_MAP = """
    class Agent:
        def install(self, k, v):
            self.mapping[k] = v
"""

L1_METHOD = """
    def wipe(agent):
        agent.spill.clear()
"""


def test_l1_fires_on_unlocked_regs_mutation():
    got = findings(L1_BAD, "L1")
    assert len(got) == 1
    assert got[0].detail == "regs" and got[0].line == 4


def test_l1_quiet_under_segment_lock():
    assert not findings(L1_GOOD, "L1")


def test_l1_quiet_in_init_and_locked_and_private():
    assert not findings(L1_EXEMPT, "L1")


def test_l1_fires_on_public_unlocked_map_mutation():
    got = findings(L1_PUBLIC_MAP, "L1")
    assert len(got) == 1 and got[0].scope == "Agent.install"


def test_l1_fires_on_mutating_method_call():
    assert [f.detail for f in findings(L1_METHOD, "L1")] == ["spill"]


# ---------------------------------------------------------------------------
# L2 — lock order and blocking under the plane

L2_UNTIMED = """
    def go(ch):
        ch.plane.acquire()
"""

L2_TIMED = """
    def go(ch):
        if not ch.plane.acquire(timeout=60.0):
            raise RuntimeError("cycle")
"""

L2_PLANE_AFTER_STRIPE = """
    def bad(seg, ch):
        with seg.lock:
            with ch.plane:
                pass
"""

L2_PLANE_THEN_STRIPE = """
    def good(seg, ch):
        with ch.plane:
            with seg.lock:
                pass
"""

L2_RESULT_UNDER_PLANE = """
    def bad(ch, fut):
        with ch.plane:
            fut.result()
"""

L2_ACQUIRE_SPAN = """
    def bad(ch, fut):
        ch.plane.acquire(timeout=5)
        try:
            fut.result()
        finally:
            ch.plane.release()
"""

L2_RESULT_OUTSIDE = """
    def good(fut):
        return fut.result()
"""


def test_l2_fires_on_untimed_plane_acquire():
    got = findings(L2_UNTIMED, "L2")
    assert len(got) == 1 and got[0].detail == "plane.acquire"


def test_l2_quiet_on_timed_plane_acquire():
    assert not findings(L2_TIMED, "L2")


def test_l2_fires_on_plane_after_stripe():
    got = findings(L2_PLANE_AFTER_STRIPE, "L2")
    assert [f.detail for f in got] == ["plane-after-stripe"]


def test_l2_quiet_on_plane_then_stripe():
    assert not findings(L2_PLANE_THEN_STRIPE, "L2")


def test_l2_fires_on_result_wait_under_plane():
    assert [f.detail for f in findings(L2_RESULT_UNDER_PLANE, "L2")] \
        == [".result()"]


def test_l2_fires_after_explicit_acquire_span():
    assert [f.detail for f in findings(L2_ACQUIRE_SPAN, "L2")] \
        == [".result()"]


def test_l2_quiet_on_result_outside_plane():
    assert not findings(L2_RESULT_OUTSIDE, "L2")


# ---------------------------------------------------------------------------
# L3 — public agent mutators carry @_locked

L3_BAD = """
    class Agent:
        def __init__(self):
            self.lock = object()
            self.state = {}
        def put(self, k, v):
            self.state[k] = v
"""

L3_GOOD = """
    class Agent:
        def __init__(self):
            self.lock = object()
            self.state = {}
        @_locked
        def put(self, k, v):
            self.state[k] = v
        def put2(self, k, v):
            with self.lock:
                self.state[k] = v
        def get(self, k):
            return self.state[k]
"""

L3_NO_LOCK = """
    class Stats:
        def __init__(self):
            self.n = 0
        def bump(self):
            self.n += 1
"""


def test_l3_fires_on_public_unlocked_mutator():
    got = findings(L3_BAD, "L3")
    assert len(got) == 1 and got[0].scope == "Agent.put"


def test_l3_quiet_with_locked_decorator_or_inline_lock():
    assert not findings(L3_GOOD, "L3")


def test_l3_quiet_without_a_lock_attribute():
    assert not findings(L3_NO_LOCK, "L3")


# ---------------------------------------------------------------------------
# O1 — obs purity on hot paths

O1_BAD = """
    from repro_torch.obs import hooks as _obs
    def step(x):
        _obs.kernel_launch("k", 1, 0.0)
        return x
"""

O1_GUARDED = """
    from repro_torch.obs import hooks as _obs
    from repro_torch.obs import trace as _trace
    def step(x):
        t0 = _trace.now_us() if _obs.TRACE else 0.0
        if _obs.METRICS:
            _obs.kernel_launch("k", 1, t0)
        return x
"""

O1_GUARD_VARS = """
    from repro_torch.obs import hooks as _obs
    from repro_torch.obs import trace as _trace
    def step(x):
        trc = _obs.TRACE and _trace.current() is not None
        if trc:
            _trace.phase("p", 0.0)
        ctx = _trace.maybe_start("s", "app") if _obs.TRACE else None
        if ctx is not None:
            _trace.end(ctx)
        return x
"""

O1_OBSERVED = """
    from repro_torch.obs import trace as _trace
    def _run_pipeline_observed(x):
        _trace.phase("plane_lock", 0.0)
        return x
"""

O1_OUTSIDE_GUARD = """
    from repro_torch.obs import hooks as _obs
    from repro_torch.obs import trace as _trace
    def step(x):
        if _obs.TRACE:
            pass
        _trace.phase("p", 0.0)
        return x
"""


def test_o1_fires_on_unguarded_obs_call_in_hot_path():
    got = findings(O1_BAD, "O1", path=HOT)
    assert len(got) == 1 and got[0].detail == "_obs.kernel_launch"


def test_o1_quiet_outside_hot_paths():
    assert not findings(O1_BAD, "O1", path="src/repro_torch/launch/steps.py")


def test_o1_quiet_when_guarded():
    assert not findings(O1_GUARDED, "O1", path=HOT)


def test_o1_tracks_guard_variables_and_boolops():
    assert not findings(O1_GUARD_VARS, "O1", path=HOT)


def test_o1_exempts_observed_variants():
    assert not findings(O1_OBSERVED, "O1", path=HOT)


def test_o1_fires_outside_guard_branch():
    assert len(findings(O1_OUTSIDE_GUARD, "O1", path=HOT)) == 1


# ---------------------------------------------------------------------------
# E1 — env vars read once at import

E1_PER_CALL = """
    import os
    def use_pallas():
        return os.environ.get("REPRO_PALLAS_INTERPRET") == "1"
"""

E1_CONSTANT = """
    import os
    _ENV = "REPRO_PALLAS_INTERPRET"
    def resolve():
        return os.getenv(_ENV)
"""

E1_MODULE_LEVEL = """
    import os
    _GPV = os.environ.get("REPRO_GPV", "1") != "0"
    def enable():
        os.environ["REPRO_FLASH_ATTN"] = "1"
"""

E1_NON_REPRO = """
    import os
    def home():
        return os.environ.get("HOME")
"""


def test_e1_fires_on_per_call_env_read():
    got = findings(E1_PER_CALL, "E1")
    assert len(got) == 1 and got[0].detail == "REPRO_PALLAS_INTERPRET"


def test_e1_resolves_module_constants():
    assert [f.detail for f in findings(E1_CONSTANT, "E1")] \
        == ["REPRO_PALLAS_INTERPRET"]


def test_e1_quiet_at_module_level_and_on_writes():
    assert not findings(E1_MODULE_LEVEL, "E1")


def test_e1_quiet_on_non_repro_vars():
    assert not findings(E1_NON_REPRO, "E1")


# ---------------------------------------------------------------------------
# S1 — schema options handled or rejected

S1_UNHANDLED = """
    class SchemaError(ValueError):
        pass
    class _FieldSpec:
        _OPTIONS = {"agg": ("precision", "frobnicate")}
        def __call__(self, **kw):
            if "precision" in kw:
                pass
            raise SchemaError("unknown")
"""

S1_NO_REJECT = """
    class _FieldSpec:
        _OPTIONS = {"agg": ("precision",)}
        def __call__(self, **kw):
            if "precision" in kw:
                pass
"""

S1_ALL_HANDLED = """
    class SchemaError(ValueError):
        pass
    class _FieldSpec:
        _OPTIONS = {"agg": ("precision", "clear")}
        def __call__(self, **kw):
            for opt in kw:
                if opt not in ("precision", "clear"):
                    raise SchemaError(opt)
"""

S1_LOCAL_ACCUM_UNHANDLED = """
    class SchemaError(ValueError):
        pass
    class _FieldSpec:
        _OPTIONS = {"agg": ("precision", "local_accum")}
        def __call__(self, **kw):
            if "precision" in kw:
                pass
            raise SchemaError("unknown")
"""

S1_LOCAL_ACCUM_HANDLED = """
    class SchemaError(ValueError):
        pass
    class _FieldSpec:
        _OPTIONS = {"agg": ("precision", "local_accum")}
        def __call__(self, **kw):
            if "precision" in kw:
                pass
            if "local_accum" in kw:
                if int(kw["local_accum"]) < 1:
                    raise SchemaError("local_accum must be >= 1")
            raise SchemaError("unknown")
"""


def test_s1_fires_on_unhandled_option():
    assert [f.detail for f in findings(S1_UNHANDLED, "S1")] \
        == ["frobnicate"]


def test_s1_fires_when_nothing_rejects():
    assert [f.detail for f in findings(S1_NO_REJECT, "S1")] \
        == ["<no-rejection>"]


def test_s1_quiet_when_all_options_handled():
    assert not findings(S1_ALL_HANDLED, "S1")


def test_s1_fires_on_surfaced_but_unhandled_local_accum():
    """An _OPTIONS entry advertising ``local_accum`` without any code
    mentioning it is exactly the drift S1 exists for."""
    assert [f.detail for f in findings(S1_LOCAL_ACCUM_UNHANDLED, "S1")] \
        == ["local_accum"]


def test_s1_quiet_on_handled_local_accum():
    """The real schema.py shape: ``local_accum`` surfaced in _OPTIONS and
    handled by name in the option-validation body."""
    assert not findings(S1_LOCAL_ACCUM_HANDLED, "S1")


# ---------------------------------------------------------------------------
# D1 — dead code

D1_UNUSED = """
    import os
    import sys
    print(sys.argv)
"""

D1_NOQA_ALL = """
    import os  # noqa: F401 (re-export)
    from x import y
    __all__ = ["y"]
"""

D1_USED = """
    import os
    print(os.sep)
"""

D1_INIT = "import os\nimport sys\n"
INIT = "src/repro_torch/analysis/__init__.py"

D1_UNREACHABLE = """
    def f():
        return 1
        print("never")
"""


def test_d1_fires_on_unused_import():
    assert [f.detail for f in findings(D1_UNUSED, "D1")] == ["os"]


def test_d1_honors_noqa_and_all_and_init():
    assert not findings(D1_NOQA_ALL, "D1")
    assert not findings(D1_USED, "D1")
    assert not findings(D1_INIT, "D1", path=INIT)


def test_d1_fires_on_unreachable_statement():
    got = findings(D1_UNREACHABLE, "D1")
    assert [f.detail for f in got] == ["unreachable"] and got[0].line == 4


# ---------------------------------------------------------------------------
# pragmas

P_REASON = """
    import os
    def f():
        # planelint: allow(E1) — fixture wants the dynamic read
        return os.environ.get("REPRO_X")
"""

P_SAME_LINE_STAR = """
    import os
    def f():
        return os.environ.get("REPRO_X")  # planelint: allow(*) — testing
"""

P_NO_REASON = """
    import os
    def f():
        # planelint: allow(E1)
        return os.environ.get("REPRO_X")
"""


def test_pragma_with_reason_suppresses():
    assert not findings(P_REASON)


def test_pragma_same_line_and_star():
    assert not findings(P_SAME_LINE_STAR)


def test_pragma_without_reason_does_not_suppress():
    assert rules_of(P_NO_REASON) == {"E1", "P1"}


# ---------------------------------------------------------------------------
# baseline round-trip + CLI exit codes

BAD_FILE = textwrap.dedent("""
    import os
    def f():
        return os.environ.get("REPRO_X")
""")


def test_baseline_round_trip(tmp_path):
    fx = tmp_path / "fixture.py"
    fx.write_text(BAD_FILE)
    bl = tmp_path / "baseline.json"
    assert cli_main([str(fx), "--write-baseline", str(bl)]) == 0
    data = json.loads(bl.read_text())
    assert len(data["entries"]) == 1
    data["entries"][0]["reason"] = "kept on purpose for the round-trip"
    bl.write_text(json.dumps(data))
    res = run([str(fx)], str(bl))
    assert not res["new"] and not res["stale"]
    assert len(res["baselined"]) == 1
    assert cli_main([str(fx), "--baseline", str(bl)]) == 0


def test_baseline_requires_reasons(tmp_path):
    fx = tmp_path / "fixture.py"
    fx.write_text(BAD_FILE)
    bl = tmp_path / "baseline.json"
    cli_main([str(fx), "--write-baseline", str(bl)])
    data = json.loads(bl.read_text())
    data["entries"][0]["reason"] = ""
    bl.write_text(json.dumps(data))
    with pytest.raises(baseline.BaselineError):
        baseline.load(str(bl))
    assert cli_main([str(fx), "--baseline", str(bl)]) == 2


def test_stale_baseline_fails(tmp_path):
    fx = tmp_path / "fixture.py"
    fx.write_text("x = 1\n")
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"entries": [
        {"rule": "E1", "file": "fixture.py", "scope": "f",
         "detail": "REPRO_GONE", "reason": "was fixed"}]}))
    assert cli_main([str(fx), "--baseline", str(bl)]) == 2


def test_cli_exit_one_on_new_finding(tmp_path):
    fx = tmp_path / "fixture.py"
    fx.write_text(BAD_FILE)
    assert cli_main([str(fx), "--no-baseline"]) == 1
    assert cli_main([str(fx), "--no-baseline", "--json"]) == 1


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        assert rule in out


# ---------------------------------------------------------------------------
# the tree itself

def test_repo_tree_is_clean_against_committed_baseline():
    """The tier-1 gate: src/repro_torch must produce exactly the port's
    committed baseline — no new findings, no stale entries."""
    res = run([str(SRC)], str(BASELINE))
    assert not res["errors"], res["errors"]
    new = "\n".join(f"{f.location()}: {f.rule} {f.message}"
                    for f in res["new"])
    assert not res["new"], f"non-baselined planelint findings:\n{new}"
    assert not res["stale"], (
        f"stale baseline entries (fix the baseline): {res['stale']}")
    assert res["files"] > 90


def test_committed_baseline_entries_all_carry_reasons():
    """The port's baseline is empty: the port has no per-call REPRO_*
    read (REPRO_FLASH_ATTN and REPRO_QUANTIZED_GATHER became explicit
    flags, REPRO_PALLAS_INTERPRET has no counterpart, and REPRO_OBS,
    REPRO_GPV and REPRO_PLANE_LOCK_TIMEOUT are read at import), and it
    grandfathers nothing else. A finding is fixed, not baselined."""
    assert json.loads(BASELINE.read_text()) == {"entries": []}
    assert baseline.load(str(BASELINE)) == []


def test_analyzer_is_stdlib_only():
    """Zero-dependency guarantee: importing and running the analyzer
    pulls nothing outside the stdlib, repro_torch and
    repro_torch.analysis: no torch, no jax, nothing of repro."""
    prog = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import repro_torch.analysis.cli\n"
        "import repro_torch.analysis\n"
        "repro_torch.analysis.analyze_source('import os\\n')\n"
        "stdlib = set(sys.stdlib_module_names)\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] not in stdlib\n"
        "             and not (m == 'repro_torch' "
        "or m.startswith('repro_torch.analysis')))\n"
        "assert not bad, bad\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('torch', 'jax', 'jaxlib', 'repro')], 'loaded'\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, cwd=str(REPO),
                          timeout=60)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# quick-fix regressions: PLANE_LOCK_TIMEOUT

def test_plane_lock_timeout_env_override():
    """REPRO_PLANE_LOCK_TIMEOUT is honored once, at import (E1)."""
    env = dict(os.environ, REPRO_PLANE_LOCK_TIMEOUT="7.5",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import repro_torch.core.rpc as r; print(r.PLANE_LOCK_TIMEOUT)"],
        env=env, capture_output=True, text=True, cwd=str(REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "7.5"


def test_cyclic_handler_diagnostic_still_names_the_channel(monkeypatch):
    """The timeout stays a call-time module-global read, so rebinding it
    still works and the cyclic-handler RuntimeError names the blocked
    channel."""
    from repro_torch.core import rpc as rpc_mod
    from repro_torch.core.netfilter import NetFilter
    from repro_torch.core.rpc import Field, NetRPC, Service

    svc = Service("Mon")
    svc.rpc("Bump", [Field("kvs", "STRINTMap")], [Field("msg")],
            NetFilter.from_dict({"AppName": "CYCLE-1",
                                 "addTo": "Req.kvs"}))
    rt = NetRPC(device="cpu")
    stub = rt.make_stub(svc)
    stub.call("Bump", {"kvs": {"a": 1}})
    ch = rt.controller.lookup("CYCLE-1")
    monkeypatch.setattr(rpc_mod, "PLANE_LOCK_TIMEOUT", 0.05)
    acquired, release = threading.Event(), threading.Event()

    def holder():
        ch.plane.acquire()
        acquired.set()
        release.wait(10)
        ch.plane.release()

    t = threading.Thread(target=holder)
    t.start()
    try:
        assert acquired.wait(10)
        with pytest.raises(RuntimeError, match="CYCLE-1") as exc:
            stub.call("Bump", {"kvs": {"a": 1}})
        assert "cyclic" in str(exc.value)
    finally:
        release.set()
        t.join(timeout=10)


# ---------------------------------------------------------------------------
# differential: the port's analyzer against repro.analysis

FIXTURES = {
    "L1_BAD": (L1_BAD, FIXTURE), "L1_GOOD": (L1_GOOD, FIXTURE),
    "L1_EXEMPT": (L1_EXEMPT, FIXTURE),
    "L1_PUBLIC_MAP": (L1_PUBLIC_MAP, FIXTURE),
    "L1_METHOD": (L1_METHOD, FIXTURE),
    "L2_UNTIMED": (L2_UNTIMED, FIXTURE), "L2_TIMED": (L2_TIMED, FIXTURE),
    "L2_PLANE_AFTER_STRIPE": (L2_PLANE_AFTER_STRIPE, FIXTURE),
    "L2_PLANE_THEN_STRIPE": (L2_PLANE_THEN_STRIPE, FIXTURE),
    "L2_RESULT_UNDER_PLANE": (L2_RESULT_UNDER_PLANE, FIXTURE),
    "L2_ACQUIRE_SPAN": (L2_ACQUIRE_SPAN, FIXTURE),
    "L2_RESULT_OUTSIDE": (L2_RESULT_OUTSIDE, FIXTURE),
    "L3_BAD": (L3_BAD, FIXTURE), "L3_GOOD": (L3_GOOD, FIXTURE),
    "L3_NO_LOCK": (L3_NO_LOCK, FIXTURE),
    "O1_BAD": (O1_BAD, HOT),
    "O1_BAD_COLD": (O1_BAD, "src/repro_torch/launch/steps.py"),
    "O1_GUARDED": (O1_GUARDED, HOT), "O1_GUARD_VARS": (O1_GUARD_VARS, HOT),
    "O1_OBSERVED": (O1_OBSERVED, HOT),
    "O1_OUTSIDE_GUARD": (O1_OUTSIDE_GUARD, HOT),
    "E1_PER_CALL": (E1_PER_CALL, FIXTURE),
    "E1_CONSTANT": (E1_CONSTANT, FIXTURE),
    "E1_MODULE_LEVEL": (E1_MODULE_LEVEL, FIXTURE),
    "E1_NON_REPRO": (E1_NON_REPRO, FIXTURE),
    "S1_UNHANDLED": (S1_UNHANDLED, FIXTURE),
    "S1_NO_REJECT": (S1_NO_REJECT, FIXTURE),
    "S1_ALL_HANDLED": (S1_ALL_HANDLED, FIXTURE),
    "S1_LOCAL_ACCUM_UNHANDLED": (S1_LOCAL_ACCUM_UNHANDLED, FIXTURE),
    "S1_LOCAL_ACCUM_HANDLED": (S1_LOCAL_ACCUM_HANDLED, FIXTURE),
    "D1_UNUSED": (D1_UNUSED, FIXTURE), "D1_NOQA_ALL": (D1_NOQA_ALL, FIXTURE),
    "D1_USED": (D1_USED, FIXTURE), "D1_INIT": (D1_INIT, INIT),
    "D1_UNREACHABLE": (D1_UNREACHABLE, FIXTURE),
    "P_REASON": (P_REASON, FIXTURE),
    "P_SAME_LINE_STAR": (P_SAME_LINE_STAR, FIXTURE),
    "P_NO_REASON": (P_NO_REASON, FIXTURE),
    "BAD_FILE": (BAD_FILE, FIXTURE),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_matches_reference(name):
    source, path = FIXTURES[name]
    source = textwrap.dedent(source)
    ref_source, ref_path = _as_reference(source, path)
    assert ref_path.startswith("src/repro/")
    ours = analyze_source(source, path=path)
    theirs = ref_planelint.analyze_source(ref_source, path=ref_path)
    assert _rows(ours) == _rows(theirs)
    assert {f.path for f in ours} <= {path}


def test_blind_spot_inplace_torch_method():
    """A torch in-place method on protected state outside its lock is an
    L1 finding, as rebinding the attribute is under both analyzers."""
    for write in ("self.regs.copy_(v)", "self.regs.zero_()",
                  "self.regs[0:2].fill_(v)", "self.spill.index_put_(v, v)"):
        src = textwrap.dedent(f"""
            class Segment:
                def load(self, v):
                    {write}
        """)
        ref_src, ref_path = _as_reference(src, FIXTURE)
        assert ref_planelint.analyze_source(ref_src, path=ref_path) == []
        got = analyze_source(src, path=FIXTURE)
        assert [(f.rule, f.line, f.scope) for f in got] \
            == [("L1", 4, "Segment.load")], write
        locked = src.replace(f"    {write}",
                             f"    with self.lock:\n            {write}")
        assert analyze_source(locked, path=FIXTURE) == []
    rebind = textwrap.dedent("""
        class Segment:
            def load(self, v):
                self.regs = v
    """)
    for got in (analyze_source(rebind, path=FIXTURE),
                ref_planelint.analyze_source(
                    *_as_reference(rebind, FIXTURE))):
        assert [(f.rule, f.line, f.detail) for f in got] \
            == [("L1", 4, "regs")]


def test_exit_stack_locks_order_and_extent():
    """An ExitStack's entered lock is held from the enter_context call
    to the end of the with-body, loops included, and L2 reads it."""
    src = textwrap.dedent("""
        import contextlib
        from repro_torch.kernels import ops
        def transmit(segs, ch, v):
            with contextlib.ExitStack() as held:
                ops.device_addto_dense_runs([(s.regs, 0, 0, 1) for s in segs],
                                            v, 1.0)
                for s in segs:
                    held.enter_context(s.lock)
                ops.device_addto_dense_runs([(s.regs, 0, 0, 1) for s in segs],
                                            v, 1.0)
                held.enter_context(ch.plane)
            with contextlib.ExitStack() as stack:
                stack.enter_context(ch.plane)
                for s in segs:
                    stack.enter_context(s.lock)
    """)
    got = analyze_source(src, path=HOT)
    assert [(f.rule, f.line, f.detail) for f in got] \
        == [("L1", 6, "regs"), ("L2", 12, "plane-after-stripe")]


def test_blind_spot_exit_stack_transmit(tmp_path):
    """The port's multi-segment transmit writes every segment through
    ``ops.device_addto_dense_runs`` under locks taken on an ExitStack.
    Without the enter_context the port's analyzer gives L1 at the kernel
    call; the reference's sees neither the write nor the locks. (The
    untouched file gives none under the reference's either: see its
    tree-wide run in test_blind_spot_baseline_and_keys.)"""
    text = (SRC / "core" / "inc_map.py").read_text()
    take = "held.enter_context(r[0].lock)"
    assert text.count(take) == 1
    assert analyze_source(text, path="src/repro_torch/core/inc_map.py") == []
    cut = tmp_path / "src" / "repro_torch" / "core" / "inc_map.py"
    cut.parent.mkdir(parents=True)
    cut.write_text(text.replace(take, "pass"))
    line = text.splitlines().index(
        "                ops.device_addto_dense_runs(") + 1
    assert ref_planelint.analyze_paths([str(cut)])[0] == []
    got = analyze_paths([str(cut)])[0]
    assert [(f.rule, f.line, f.detail, f.path) for f in got] \
        == [("L1", line, "regs", "src/repro_torch/core/inc_map.py")]


def test_blind_spot_obs_package(tmp_path):
    """O1 reads the port's ``repro_torch.obs`` aliases: one unguarded
    ``_obs.pipeline_pass`` on the port's pipeline is a finding, where
    the reference's sees no obs alias in the port at all."""
    text = (SRC / "core" / "rpc.py").read_text()
    guard = "    if not (_obs.METRICS or _obs.TRACE):\n"
    assert text.count(guard) == 1
    bad = ("    _obs.pipeline_pass(channel.netfilter.app_name, len(calls), "
           "source, 0.0)\n")
    cut = tmp_path / "src" / "repro_torch" / "core" / "rpc.py"
    cut.parent.mkdir(parents=True)
    cut.write_text(text.replace(guard, bad + guard))
    line = text[:text.index(guard)].count("\n") + 1
    assert ref_planelint.analyze_paths([str(cut)])[0] == []
    got = analyze_paths([str(cut)])[0]
    assert [(f.rule, f.line, f.scope, f.detail) for f in got] \
        == [("O1", line, "_run_pipeline", "_obs.pipeline_pass")]


def test_blind_spot_baseline_and_keys(tmp_path, monkeypatch, capsys):
    """The reference's CLI over the port picks up the JAX package's
    baseline and reports its 4 entries stale (exit 2); the port's finds
    its own empty baseline and exits 0 from any directory, and a
    finding's key does not depend on the directory it ran from."""
    monkeypatch.chdir(REPO)
    assert ref_cli_main([str(SRC), "--json"]) == 2
    out = json.loads(capsys.readouterr().out)
    assert out["findings"] == [] and len(out["stale"]) == 4
    assert all(e["file"].startswith("src/repro/") for e in out["stale"])
    for cwd in (REPO, tmp_path):
        monkeypatch.chdir(cwd)
        assert cli_main(["--json"]) == 0
        assert json.loads(capsys.readouterr().out) \
            == {"findings": [], "stale": []}
    hot = tmp_path / "src" / "repro_torch" / "core" / "rpc.py"
    hot.parent.mkdir(parents=True)
    hot.write_text(textwrap.dedent(O1_BAD))
    keys = []
    for cwd, path in ((tmp_path, "src/repro_torch"),
                      (tmp_path / "src", "repro_torch"),
                      (tmp_path / "src" / "repro_torch", "."),
                      (REPO, str(hot))):
        monkeypatch.chdir(cwd)
        assert cli_main([path, "--no-baseline", "--json"]) == 1
        keys.append([(f["rule"], f["file"], f["scope"], f["detail"])
                     for f in json.loads(capsys.readouterr().out)["findings"]])
    assert keys == [[("O1", "src/repro_torch/core/rpc.py", "step",
                      "_obs.kernel_launch")]] * 4
