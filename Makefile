PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH))
export PYTHONPATH

.PHONY: test test-fast lint-plane lint-plane-torch examples bench-batch bench-accum \
	bench-async bench-wire bench-shard bench-device bench-obs \
	bench-wire-proc trace-shard

# full tier-1 suite (includes the slow multidevice subprocess tests)
test:
	python -m pytest -q

# plane-invariant static analyzer (planelint): lock discipline, obs
# purity, env/schema hygiene over src/repro — see docs/ANALYSIS.md.
# Fails on any finding not pragma'd or baselined, and on stale baseline
# entries.
lint-plane:
	python -m repro.analysis src/repro

# the port's planelint (repro_torch.analysis): the same rules over
# src/repro_torch, read in the port's idiom, against its own (empty)
# baseline scripts/planelint_torch_baseline.json
lint-plane-torch:
	python -m repro_torch.analysis src/repro_torch

# fast lane: non-slow suite + delta vs the seed baseline
test-fast:
	bash scripts/ci.sh

# the typed-schema INC example apps (each self-asserts its results)
examples:
	python -m examples.quickstart
	python -m examples.mapreduce
	python -m examples.monitoring
	python -m examples.paxos
	python -m examples.train_telemetry

# batched RPC data-plane sweep (calls/sec vs batch size)
bench-batch:
	python benchmarks/agg_goodput.py --batch

# client-side local aggregation sweep (effective calls/sec vs local_accum,
# gate: >=3x at local_accum=8 + element-exact host/device differential)
bench-accum:
	python benchmarks/agg_goodput.py --local-accum

# async runtime sweep: p50/p99 latency + throughput per auto-drain trigger
bench-async:
	python benchmarks/async_latency.py

# GPV wire-path sweep: tensor marshalling calls/sec, dict path vs array path
bench-wire:
	python benchmarks/wire_path.py --csv

# sharded-plane sweep: M channels x workers in {1,2,4}, weighted fairness
bench-shard:
	python benchmarks/multi_channel.py --csv

# device-resident GPV sweep: fused Pallas addto/read vs the host path
bench-device:
	python benchmarks/device_path.py --csv

# observability overhead gate: disabled <= 2%, enabled <= 10% on the bulk
# hot path, plus end-to-end snapshot/trace export validation
bench-obs:
	python benchmarks/obs_overhead.py

# multi-process wire plane vs in-process plane: switchd subprocess over a
# Unix socket, chaos-exactness probe (hard gate) + throughput ratio at 64k
# (gate: >= 0.8x of in-process) -> benchmarks/BENCH_wire_proc.json
bench-wire-proc:
	python benchmarks/wire_proc.py

# one traced workers=4 window -> benchmarks/TRACE_multi_channel.json
# (load in Perfetto / chrome://tracing)
trace-shard:
	python benchmarks/multi_channel.py --trace
