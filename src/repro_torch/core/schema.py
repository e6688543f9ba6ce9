"""Typed declarative service schema: the NetRPC front door (paper §4).

The paper's pitch is that an INC application is described with "a set of
familiar and lightweight interfaces ... using a traditional RPC
programming model".  The legacy surface (``Service("X"); svc.rpc(name,
[Field(...)], ..., NetFilter.from_dict({...}))``) is stringly-typed and
its mistakes surface only at drain time.  This module is the typed
replacement: a service is a decorated class whose RPC methods carry INC
semantics as field *annotations*, validated eagerly at class-definition
time and lowered into the existing ``Service``/``NetFilter`` machinery —
the wire/pipeline semantics are exactly the legacy ones (the golden tests
assert byte-identical ``NetFilter.to_dict()`` output).

    import repro_torch.api as inc

    @inc.service(app="DT-1")
    class Gradient:
        @inc.rpc(request_msg="NewGrad", reply_msg="AgtrGrad",
                 cnt_fwd=inc.CntFwd(to="ALL", threshold=2, key="ClientID"))
        def Update(self, tensor: inc.Agg[inc.FPArray](precision=8,
                                                      clear="copy")
                   ) -> {"tensor": inc.Get[inc.FPArray]}: ...

    rt = inc.IncRuntime()
    stub = rt.make_stub(Gradient)          # a *generated typed stub*
    fut = stub.Update(tensor=grad)         # every invocation -> IncFuture
    reply = fut.result()                   # .result() is the sync path
    futs = stub.Update.batch([...])        # bulk submission, same triggers

Annotation vocabulary (request side unless noted):

  ``Agg[T](precision=, clear=, modify=)``
      the Map.addTo stream: this field's items are aggregated in-network.
      ``modify`` is the Stream.modify stage: ``("max", 3)`` / ``"nop"``.
  ``ReadMostly[T](precision=, clear=)``
      a read query: the field carries keys; their aggregated values come
      back in the same-named reply field via Map.get.
  ``Get[T]``             (reply side) the Map.get target field.
  ``FPArray / IntArray / STRINTMap / Integer``
      bare IEDT field: travels the INC channel, not passed to the handler.
  ``Plain`` (or any vanilla annotation / none)
      pass-through field, delivered to the server handler untouched.

RPC-level options on ``@inc.rpc``: ``app`` (AppName override — one class
may span several channels, e.g. paxos-prepare/paxos-accept),
``request_msg``/``reply_msg`` (message names used in addTo/get targets,
default ``<Rpc>Request``/``<Rpc>Reply``), ``cnt_fwd=CntFwd(...)`` and a
per-RPC ``drain=DrainPolicy(...)`` scheduler override for the RPC's
channel.

Every mistake — unknown field option, precision out of range, two addTo
streams, a Get on the request side, conflicting clear policies, a CntFwd
threshold without a key, clashing DrainPolicy overrides on one channel —
raises ``SchemaError`` at class-definition time with the offending
``Class.method`` named, instead of a bare ValueError mid-drain.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field, replace
from typing import Any

from repro_torch.core.netfilter import (CLEAR_POLICIES, CNTFWD_TARGETS,
                                        NetFilter)
from repro_torch.core.rpc import Field, IncFuture, Service, Stub
from repro_torch.kernels.ref import STREAM_OPS


class SchemaError(ValueError):
    """A service schema mistake, reported at definition time."""


# -- IEDT markers -------------------------------------------------------------

class _IEDT:
    """Marker base: a field that travels the INC channel."""
    iedt: str


class FPArray(_IEDT):
    iedt = "FPArray"


class IntArray(_IEDT):
    iedt = "IntArray"


class STRINTMap(_IEDT):
    iedt = "STRINTMap"


class Integer(_IEDT):
    iedt = "Integer"


class Plain:
    """Vanilla pass-through field (delivered to the server handler)."""


def _iedt_name(t: Any, ctx: str) -> str:
    if isinstance(t, type) and issubclass(t, _IEDT):
        return t.iedt
    raise SchemaError(f"{ctx}: expected an IEDT marker "
                      f"(FPArray/IntArray/STRINTMap/Integer), got {t!r}")


def _norm_modify(modify: Any, ctx: str):
    """Normalize a modify= option to ("op", para)."""
    if modify is None or modify == "nop":
        return ("nop", 0)
    if isinstance(modify, str):
        op, para = modify, 0
    elif isinstance(modify, dict):
        unknown = set(modify) - {"op", "para"}
        if unknown:
            raise SchemaError(f"{ctx}: unknown modify keys {sorted(unknown)}"
                              f" (known: op, para)")
        op, para = modify.get("op", "nop"), int(modify.get("para", 0))
    elif isinstance(modify, (tuple, list)) and len(modify) == 2:
        op, para = modify[0], int(modify[1])
    else:
        raise SchemaError(f"{ctx}: modify must be 'op', (op, para) or "
                          f"{{'op':..,'para':..}}, got {modify!r}")
    if op not in STREAM_OPS:
        raise SchemaError(f"{ctx}: Stream.modify op must be one of "
                          f"{STREAM_OPS}, got {op!r}")
    return (op, para)


# -- field annotation specs ---------------------------------------------------

@dataclass(frozen=True)
class _FieldSpec:
    """Configured INC role for one field.  Immutable; calling a spec with
    keyword options returns a reconfigured copy, so the annotation form
    ``Agg[FPArray](precision=8, clear="copy")`` reads declaratively."""
    role: str                    # "agg" | "read" | "get"
    iedt: str
    precision: int | None = None
    clear: str | None = None
    modify: tuple | None = None
    device: bool | None = None
    local_accum: int | None = None

    _OPTIONS = {"agg": ("precision", "clear", "modify", "device",
                        "local_accum"),
                "read": ("precision", "clear", "device"),
                "get": ("precision", "clear", "device")}
    _NAMES = {"agg": "Agg", "read": "ReadMostly", "get": "Get"}

    def __call__(self, **kw) -> "_FieldSpec":
        ctx = f"{self._NAMES[self.role]}[{self.iedt}]"
        allowed = self._OPTIONS[self.role]
        unknown = set(kw) - set(allowed)
        if unknown:
            raise SchemaError(f"{ctx}: unknown option(s) {sorted(unknown)} "
                              f"(known: {', '.join(allowed)})")
        if "device" in kw:
            if kw["device"] is not None:
                kw["device"] = bool(kw["device"])
            if kw["device"] and self.iedt not in ("FPArray", "IntArray"):
                raise SchemaError(
                    f"{ctx}: device=True needs a dense array IEDT "
                    f"(FPArray/IntArray) — map-typed fields have no "
                    f"contiguous device-resident layout")
        if "precision" in kw:
            p = int(kw["precision"])
            if not (0 <= p <= 9):
                raise SchemaError(f"{ctx}: precision must be in [0, 9] "
                                  f"(10**p must fit the int32 fixed-point "
                                  f"range headroom), got {p}")
            kw["precision"] = p
        if "clear" in kw and kw["clear"] not in CLEAR_POLICIES:
            raise SchemaError(f"{ctx}: clear must be one of "
                              f"{CLEAR_POLICIES}, got {kw['clear']!r}")
        if "modify" in kw:
            kw["modify"] = _norm_modify(kw["modify"], ctx)
        if "local_accum" in kw:
            n = kw["local_accum"]
            if isinstance(n, bool) or not isinstance(n, int) or n < 1:
                raise SchemaError(f"{ctx}: local_accum must be an int >= 1 "
                                  f"(the number of addTo rounds folded "
                                  f"client-side per switch update), got "
                                  f"{n!r}")
            kw["local_accum"] = n
        return replace(self, **kw)


class _SpecFactory:
    """``Agg[FPArray]`` / ``Get[STRINTMap]`` / ``ReadMostly[STRINTMap]``."""

    def __init__(self, role: str):
        self._role = role

    def __getitem__(self, t) -> _FieldSpec:
        name = _FieldSpec._NAMES[self._role]
        return _FieldSpec(role=self._role,
                          iedt=_iedt_name(t, f"{name}[...]"))


Agg = _SpecFactory("agg")
ReadMostly = _SpecFactory("read")
Get = _SpecFactory("get")


@dataclass(frozen=True)
class CntFwd:
    """The counting-forward gate (paper Table 2) as an RPC option."""
    to: str = "SRC"
    threshold: int = 0
    key: str = "NULL"

    def __post_init__(self):
        if self.to not in CNTFWD_TARGETS:
            raise SchemaError(f"CntFwd: 'to' must be one of "
                              f"{CNTFWD_TARGETS}, got {self.to!r}")
        if self.threshold < 0:
            raise SchemaError("CntFwd: threshold must be >= 0, got "
                              f"{self.threshold}")
        if self.threshold > 0 and (not self.key or self.key == "NULL"):
            raise SchemaError("CntFwd: a positive threshold needs a vote "
                              "key (the field whose first entry tags the "
                              "ballot), got key=NULL")


# -- the @rpc / @service decorators -------------------------------------------

@dataclass(frozen=True)
class _RpcOptions:
    app: str | None = None
    request_msg: str | None = None
    reply_msg: str | None = None
    cnt_fwd: CntFwd | None = None
    drain: Any = None               # runtime DrainPolicy (kept untyped to
    #                                 avoid importing core.runtime here)


def _merge_sched(drain, priority, weight, ctx: str):
    """Fold ``priority=``/``weight=`` shorthands into the (possibly
    absent) DrainPolicy override — the scheduling-class annotation of the
    weighted-fair drain loop (core/runtime.py). Imported lazily so this
    module keeps no module-level dependency on core.runtime."""
    if priority is None and weight is None:
        return drain
    from repro_torch.core.runtime import DrainPolicy
    kw = {}
    if priority is not None:
        if not isinstance(priority, int) or isinstance(priority, bool):
            raise SchemaError(f"{ctx}: priority must be an int (strict "
                              f"drain tier; higher drains first), got "
                              f"{priority!r}")
        kw["priority"] = priority
    if weight is not None:
        try:
            weight = float(weight)
        except (TypeError, ValueError):
            weight = -1.0
        if not (weight > 0):       # also rejects NaN, which compares False
            raise SchemaError(f"{ctx}: weight must be a number > 0 (the "
                              f"DRR share within the priority tier)")
        kw["weight"] = weight
    if drain is None:
        return DrainPolicy(**kw)
    if not isinstance(drain, DrainPolicy):
        raise SchemaError(f"{ctx}: drain must be an inc.DrainPolicy to "
                          f"combine with priority=/weight=, got {drain!r}")
    return replace(drain, **kw)


def rpc(fn=None, *, app: str | None = None, request_msg: str | None = None,
        reply_msg: str | None = None, cnt_fwd: CntFwd | None = None,
        drain=None, priority: int | None = None,
        weight: float | None = None):
    """Mark a schema-class method as an RPC.  Usable bare (``@inc.rpc``)
    or configured (``@inc.rpc(cnt_fwd=..., request_msg=...)``).
    ``priority=``/``weight=`` are scheduling-class shorthands: they place
    the RPC's channel in the weighted-fair drain loop (strict tiers, DRR
    within a tier) without spelling a full DrainPolicy."""
    if cnt_fwd is not None and not isinstance(cnt_fwd, CntFwd):
        raise SchemaError(f"@rpc: cnt_fwd must be an inc.CntFwd, "
                          f"got {cnt_fwd!r}")
    drain = _merge_sched(drain, priority, weight, "@rpc")
    opts = _RpcOptions(app=app, request_msg=request_msg,
                       reply_msg=reply_msg, cnt_fwd=cnt_fwd, drain=drain)

    def deco(f):
        f.__inc_rpc__ = opts
        return f
    if fn is not None:
        if not callable(fn):
            raise SchemaError("@rpc: use keyword options, e.g. "
                              "@inc.rpc(cnt_fwd=...)")
        return deco(fn)
    return deco


@dataclass(frozen=True)
class RpcSchema:
    """One compiled RPC: the validated, lowered view of a decorated
    method."""
    name: str
    app: str
    request: tuple[Field, ...]
    reply: tuple[Field, ...]
    netfilter: NetFilter
    drain: Any = None
    device: bool = False         # device-resident register partition
    local_accum: int = 1         # addTo rounds folded client-side per flush


@dataclass
class ServiceSchema:
    """A compiled service class: legacy ``Service`` + per-channel drain
    overrides + per-RPC metadata.  ``make_stub`` binds it to a runtime."""
    name: str
    rpcs: dict[str, RpcSchema] = field(default_factory=dict)
    service: Service = None
    channel_policies: dict[str, Any] = field(default_factory=dict)
    # apps whose register partition is device-resident (any RPC on the
    # channel declared device=True): make_stub registers their channels
    # with a DeviceSegment-backed ServerAgent
    device_apps: dict[str, bool] = field(default_factory=dict)

    def bind(self, stub: Stub) -> "TypedStub":
        # typed surface opts into the GPV wire format: FPArray/IntArray
        # Map.get replies come back as ndarrays (request-shaped) when the
        # request field was array-shaped; map-typed fields stay dicts.
        # Stubs built from a legacy Service never set this, so the
        # string-keyed compat surface keeps its {index: value} dicts.
        stub.reply_arrays = True
        # device=True RPCs additionally ride the fused device GPV lane
        # (fp32 streams quantize on device; array replies are tensors)
        stub.device_methods = frozenset(
            m for m, rs in self.rpcs.items() if rs.device)
        # local_accum>1 RPCs fold client-side before the pipeline; the
        # stub-level map is what NetRPC/IncRuntime consult per call
        stub.accum_methods = {m: rs.local_accum
                              for m, rs in self.rpcs.items()
                              if rs.local_accum > 1}
        return TypedStub(self, stub)


def service(cls=None, *, app: str | None = None, name: str | None = None,
            drain=None, priority: int | None = None,
            weight: float | None = None):
    """Class decorator: compile the annotated class into a ServiceSchema
    (attached as ``__inc_schema__``) and return the class.  ``app`` is the
    default AppName for every RPC (override per-RPC); ``drain`` the
    default DrainPolicy override for the service's channels;
    ``priority=``/``weight=`` the scheduling-class shorthands (see
    :func:`rpc`)."""
    drain = _merge_sched(drain, priority, weight, "@service")

    def deco(c):
        schema = compile_service(c, default_app=app,
                                 name=name or c.__name__,
                                 default_drain=drain)
        c.__inc_schema__ = schema
        return c
    if cls is not None:
        if not isinstance(cls, type):
            raise SchemaError("@service: use keyword options, e.g. "
                              "@inc.service(app='DT-1')")
        return deco(cls)
    return deco


# -- the compile step ---------------------------------------------------------

def _classify_request(name: str, ann: Any, ctx: str):
    """annotation -> (Field, spec-or-None)."""
    if isinstance(ann, _FieldSpec):
        if ann.role == "get":
            raise SchemaError(f"{ctx}: Get[...] is a reply-side "
                              f"annotation; use Agg[...] (addTo) or "
                              f"ReadMostly[...] on request field "
                              f"{name!r}")
        return Field(name, ann.iedt), ann
    if isinstance(ann, _SpecFactory):
        raise SchemaError(f"{ctx}: field {name!r} uses bare "
                          f"{_FieldSpec._NAMES[ann._role]} — subscript it "
                          f"with an IEDT, e.g. "
                          f"{_FieldSpec._NAMES[ann._role]}[STRINTMap]")
    if isinstance(ann, type) and issubclass(ann, _IEDT):
        return Field(name, ann.iedt), None
    # Plain, a vanilla type, or no annotation: pass-through field
    return Field(name, None), None


def _classify_reply(name: str, ann: Any, ctx: str):
    if isinstance(ann, _FieldSpec):
        if ann.role != "get":
            raise SchemaError(f"{ctx}: {_FieldSpec._NAMES[ann.role]}[...] "
                              f"is a request-side annotation; only "
                              f"Get[...] configures reply field {name!r}")
        return Field(name, ann.iedt), ann
    if isinstance(ann, _SpecFactory):
        raise SchemaError(f"{ctx}: reply field {name!r} uses bare Get — "
                          f"subscript it with an IEDT, e.g. Get[FPArray]")
    if isinstance(ann, type) and issubclass(ann, _IEDT):
        return Field(name, ann.iedt), None
    return Field(name, None), None


def _merge_option(ctx: str, option: str, *values):
    """Single non-None value among the annotations of one RPC wins;
    conflicting settings are a definition-site error."""
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    if any(v != vals[0] for v in vals):
        raise SchemaError(f"{ctx}: conflicting {option!r} settings across "
                          f"field annotations: {vals}")
    return vals[0]


def _compile_rpc(cls_name: str, fname: str, fn, opts: _RpcOptions,
                 default_app: str | None) -> RpcSchema:
    ctx = f"{cls_name}.{fname}"
    app = opts.app or default_app
    if not app:
        raise SchemaError(f"{ctx}: no AppName — pass app= to @inc.service "
                          f"or to this @inc.rpc")
    req_msg = opts.request_msg or f"{fname}Request"
    reply_msg = opts.reply_msg or f"{fname}Reply"

    try:
        # eval_str resolves PEP-563 stringified annotations (a defining
        # module using `from __future__ import annotations`) back to the
        # real spec objects against the function's globals
        sig = inspect.signature(fn, eval_str=True)
    except NameError as e:
        raise SchemaError(f"{ctx}: unresolvable annotation ({e}); "
                          f"annotations must reference module-level "
                          f"names") from None
    params = [p for p in sig.parameters.values() if p.name != "self"]
    req_fields, agg, read = [], None, None
    for p in params:
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            raise SchemaError(f"{ctx}: *args/**kwargs are not valid RPC "
                              f"fields — declare each field explicitly")
        ann = None if p.annotation is p.empty else p.annotation
        f, spec = _classify_request(p.name, ann, ctx)
        req_fields.append(f)
        if spec is not None and spec.role == "agg":
            if agg is not None:
                raise SchemaError(
                    f"{ctx}: a NetFilter holds at most one Map.addTo "
                    f"stream, but both {agg[0].name!r} and {p.name!r} "
                    f"are Agg[...] fields")
            agg = (f, spec)
        elif spec is not None and spec.role == "read":
            if read is not None:
                raise SchemaError(
                    f"{ctx}: at most one ReadMostly[...] query field, "
                    f"got {read[0].name!r} and {p.name!r}")
            read = (f, spec)

    ret = sig.return_annotation
    ret = None if ret is sig.empty else ret
    reply_fields, get = [], None
    if ret is not None:
        if not isinstance(ret, dict):
            raise SchemaError(f"{ctx}: the return annotation must be a "
                              f"dict of reply fields, e.g. "
                              f"-> {{'tensor': Get[FPArray]}}, "
                              f"got {ret!r}")
        for rname, ann in ret.items():
            f, spec = _classify_reply(rname, ann, ctx)
            reply_fields.append(f)
            if spec is not None:
                if get is not None:
                    raise SchemaError(
                        f"{ctx}: a NetFilter holds at most one Map.get "
                        f"target, but both {get[0].name!r} and {rname!r} "
                        f"are Get[...] fields")
                get = (f, spec)
    if read is not None and get is not None:
        raise SchemaError(
            f"{ctx}: ReadMostly[{read[1].iedt}] on {read[0].name!r} "
            f"already names the Map.get target "
            f"({reply_msg}.{read[0].name}); drop the Get[...] reply "
            f"annotation on {get[0].name!r}")
    if read is not None and agg is not None:
        raise SchemaError(
            f"{ctx}: {read[0].name!r} is ReadMostly (a pure query) but "
            f"{agg[0].name!r} is Agg — an RPC is either a write stream "
            f"(Agg, optionally with a Get reply) or a read (ReadMostly)")

    # ReadMostly implies the same-named reply field if not declared
    if read is not None and read[0].name not in {f.name
                                                 for f in reply_fields}:
        reply_fields.append(Field(read[0].name, read[1].iedt))

    specs = [pair[1] for pair in (agg, read, get) if pair is not None]
    precision = _merge_option(ctx, "precision",
                              *[s.precision for s in specs]) or 0
    clear = _merge_option(ctx, "clear", *[s.clear for s in specs]) or "nop"
    modify = _merge_option(ctx, "modify",
                           *[s.modify for s in specs]) or ("nop", 0)
    # device residency is schema-level routing, NOT part of the NetFilter
    # wire format (NetFilter.from_dict would reject it; goldens stay
    # byte-identical) — it selects which backing store serves the channel
    device = bool(_merge_option(ctx, "device", *[s.device for s in specs]))
    if clear != "nop" and agg is None and read is None and get is None:
        raise SchemaError(f"{ctx}: clear={clear!r} without an Agg/"
                          f"ReadMostly/Get field has nothing to clear")
    # local_accum folds N addTo rounds into one switch update, so it only
    # makes sense on the Agg stream (the _OPTIONS table already keeps it
    # off Get/ReadMostly annotations) and only where per-round switch
    # state is unobservable: a CntFwd vote counts *switch* arrivals (one
    # folded flush = one vote, not N), and clear="lazy" snapshots the
    # running switch register between rounds — both would change meaning.
    local_accum = int(_merge_option(
        ctx, "local_accum", *[s.local_accum for s in specs]) or 1)
    if local_accum > 1:
        if opts.cnt_fwd is not None:
            raise SchemaError(
                f"{ctx}: local_accum={local_accum} with cnt_fwd — CntFwd "
                f"counts switch arrivals, so folding N calls into one "
                f"update would miscount votes; drop one of the two")
        if clear == "lazy":
            raise SchemaError(
                f"{ctx}: local_accum={local_accum} with clear='lazy' — "
                f"lazy clear makes per-round switch state observable "
                f"(host snapshot deltas), which folding would skew; use "
                f"clear='copy' or 'shadow'")

    nf_dict = {
        "AppName": app,
        "Precision": precision,
        "get": (f"{reply_msg}.{get[0].name}" if get is not None else
                f"{reply_msg}.{read[0].name}" if read is not None else
                "nop"),
        "addTo": (f"{req_msg}.{agg[0].name}" if agg is not None else "nop"),
        "clear": clear,
        "modify": ({"op": modify[0], "para": modify[1]}
                   if modify[0] != "nop" else "nop"),
    }
    cf = opts.cnt_fwd
    if cf is not None:
        nf_dict["CntFwd"] = {"to": cf.to, "threshold": cf.threshold,
                             "key": cf.key}
    try:
        nf = NetFilter.from_dict(nf_dict)
    except (ValueError, KeyError) as e:
        raise SchemaError(f"{ctx}: {e}") from None
    return RpcSchema(name=fname, app=app, request=tuple(req_fields),
                     reply=tuple(reply_fields), netfilter=nf,
                     drain=opts.drain, device=device,
                     local_accum=local_accum)


def compile_service(cls, *, default_app: str | None = None,
                    name: str | None = None,
                    default_drain=None) -> ServiceSchema:
    """Compile a decorated class into a ServiceSchema.  Validation is
    eager: any schema mistake raises SchemaError here, at definition
    time, naming the offending Class.method."""
    name = name or cls.__name__
    schema = ServiceSchema(name=name)
    svc = Service(name)
    for fname, fn in vars(cls).items():
        opts = getattr(fn, "__inc_rpc__", None)
        if opts is None:
            continue
        rs = _compile_rpc(cls.__name__, fname, fn, opts, default_app)
        if rs.name in schema.rpcs:
            raise SchemaError(f"{cls.__name__}: duplicate RPC {rs.name!r}")
        schema.rpcs[rs.name] = rs
        svc.rpc(rs.name, list(rs.request), list(rs.reply), rs.netfilter)
        pol = rs.drain if rs.drain is not None else default_drain
        if pol is not None:
            prev = schema.channel_policies.get(rs.app)
            if prev is not None and prev != pol:
                raise SchemaError(
                    f"{cls.__name__}: RPCs sharing channel {rs.app!r} "
                    f"declare conflicting DrainPolicy overrides "
                    f"({prev} vs {pol}); a channel has one scheduler "
                    f"policy")
            schema.channel_policies[rs.app] = pol
        if rs.device:
            # one device RPC makes the whole channel device-resident (the
            # backing store is per-partition, not per-RPC); host RPCs on
            # the same channel keep working — the int paths serve both
            schema.device_apps[rs.app] = True
    if not schema.rpcs:
        raise SchemaError(f"{cls.__name__}: no @inc.rpc methods — a "
                          f"service schema needs at least one RPC")
    schema.service = svc
    return schema


# -- the generated typed stub -------------------------------------------------

class BoundRpc:
    """One RPC of a typed stub: calling it submits through the unified
    futures-first front (``IncFuture`` always; ``.result()`` is the sync
    path); ``.batch([...])`` is bulk submission through the same
    scheduler triggers."""

    __slots__ = ("_schema", "_stub", "_fields")

    def __init__(self, schema: RpcSchema, stub: Stub):
        self._schema = schema
        self._stub = stub
        self._fields = frozenset(f.name for f in schema.request)

    @property
    def schema(self) -> RpcSchema:
        return self._schema

    def _check(self, request: dict) -> None:
        # issuperset iterates the dict keys without allocating — this is
        # the submission hot path (called per request, incl. from .batch)
        if not self._fields.issuperset(request):
            unknown = set(request) - self._fields
            raise SchemaError(
                f"{self._stub.service.name}.{self._schema.name}: unknown "
                f"request field(s) {sorted(unknown)} "
                f"(declared: {sorted(self._fields)})")

    def __call__(self, **fields) -> IncFuture:
        self._check(fields)
        return self._stub.runtime.call_async(self._stub, self._schema.name,
                                             fields)

    def batch(self, requests: list[dict]) -> list[IncFuture]:
        for r in requests:
            self._check(r)
        return self._stub.runtime.call_batch_async(
            self._stub, self._schema.name, list(requests))

    def __repr__(self) -> str:
        return (f"<rpc {self._stub.service.name}.{self._schema.name} "
                f"app={self._schema.app!r}>")


class TypedStub:
    """The generated client: one real method per declared RPC.  The
    legacy ``Stub`` it wraps stays reachable as ``.legacy`` (the compat
    shim surface); ``.channels`` / ``.agents`` alias its plumbing for
    observability."""

    def __init__(self, schema: ServiceSchema, stub: Stub):
        self.schema = schema
        self.legacy = stub
        self.channels = stub.channels
        self.agents = stub.agents
        for rname, rs in schema.rpcs.items():
            setattr(self, rname, BoundRpc(rs, stub))

    def __repr__(self) -> str:
        return (f"<TypedStub {self.schema.name} "
                f"rpcs={sorted(self.schema.rpcs)}>")
