# Build/test/package targets (reference parity: Makefile — build matrix is
# replaced by a wheel + container images since the rebuild is Python).

PY ?= python
IMAGE ?= modelx-tpu
TAG ?= $(shell git describe --tags --always 2>/dev/null || echo dev)

PHONY_TORCH = lint-torch chaos-torch
.PHONY: $(PHONY_TORCH) all native test chaos slow lifecycle fleet overload programs kv continuation obs mesh decode tiers outage lint wheel image image-dl compose-up compose-down clean

all: native lint test wheel

# native IO engine (ranged HTTP fetch / scatter pread / sha256); auto-built
# on first use too — this target just prebuilds it
native:
	$(PY) -c "from modelx_tpu import native; print(native.build(force=True))"

# the lint gate runs before tests: a concurrency-rule violation fails the
# build even when every test happens to pass
test: lint
	$(PY) -m pytest tests/ -q

# every deterministic fault sweep in one command: the seeded engine-crash
# schedules (PR 3) plus the registry torn-write/scrub/GC-race drills —
# run under runtime lockdep (analysis/lockdep.py): the sweeps double as
# lock-order validation, and an observed order cycle fails the run
chaos:
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m chaos

# the heavy compiled-exactness/soak set trimmed out of tier-1 for the
# 870 s wall-time budget (ISSUE 6 profiled the tail): every slow-marked
# test keeps its home here — run before perf- or kernel-touching merges
slow:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m slow

# model lifecycle drills (ISSUE 5): runtime load/drain/unload/evict,
# HBM-budget refusal, degraded multi-tenant boot, the bench swap leg —
# plus the chaos sweep (a crashed load must leave the pool serving and
# the slot retryable)
lifecycle:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_lifecycle.py \
		"tests/test_bench_smoke.py::TestSwapLeg" -q
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -m chaos

# fleet front-door drills (ISSUE 8): routing / stickiness / failover /
# rebalance tests plus the pod-kill chaos soak, the latter under runtime
# lockdep like every other chaos sweep (the router brings its own lock
# order: placement table, sticky LRU, metrics, in-flight counts)
fleet:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_router.py tests/test_retry.py -q
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_router.py -q -m chaos

# overload-protection drills (ISSUE 9): admission fairness / deadline
# propagation / retry-budget / breaker units + HTTP drills, then the
# 3-client storm with a mid-storm pod kill under runtime lockdep (the
# admission controller brings its own condition-variable lock order)
overload:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_admission.py -q -m "not slow"
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_admission.py -q -m chaos

# live-continuation drills (ISSUE 12): engine resume determinism, the
# resume wire contract on both HTTP surfaces, the boundary watchdog, and
# coordinated drain — then the router splice tests plus the kill/drain
# soak under runtime lockdep (continuation adds the stream-session and
# re-plan paths to the router's lock order)
continuation:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_continuation.py -q
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_router.py -q -k Continuation
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_router.py -q -m chaos

# compiled-program registry drills (ISSUE 11): bundle build/install/
# corruption/skew units + registry round-trips, then the slow set
# (byte-exact bundle-vs-plain equality, chaos swap drill) under runtime
# lockdep — the program install/publish hooks ride the pool's lock order
programs:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_program_store.py -q -m "not slow"
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_program_store.py -q -m slow

# content-addressed KV store drills (ISSUE 20): bundle build/install/
# corruption/skew units + registry round-trips + byte-exact
# installed-vs-prefilled decode, then the slow set (the dp=2,tp=2 mesh
# roundtrip and the publish -> pod-kill -> outbox-drain -> reinstall
# chaos drill) under runtime lockdep — the publisher/fetcher threads
# ride the prefix cache's and outbox's lock order
kv:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_kv_store.py -q -m "not slow"
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_kv_store.py -q -m slow

# observability drills (ISSUE 13 + 15): exposition-format round-trips,
# trace summary/decorator units, request-id propagation over HTTP; the
# flight-recorder / rate-wheel / devmem / access-log-rotation units and
# the engine crash-dump + /debug/flightrec + /admin/profile drills —
# then the pod-kill chaos soak under runtime lockdep, where the
# failed-over streams must keep their end-to-end request ids across the
# splice
obs:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_promexp.py tests/test_flightrec.py -q
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_router.py -q -k "RequestId or Observability"
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_engine_faults.py -q -k "FlightRecorder or Observability"
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_router.py -q -m chaos

# mesh-serving drills (ISSUE 16): family shard rules -> NamedSharding,
# sharded byte-range fetch math, bundle mesh-skew, per-device HBM
# budgeting + telemetry, and the multi-device continuous-decode matrix
# (tier-1 keeps one dp=1 byte-equality representative; the heavy
# mesh-shape sweeps live in the slow set) — then the engine chaos sweep
# under runtime lockdep, since the sharded engine reuses the dispatch/
# supervisor lock order the fault drills validate
mesh:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_loader.py tests/test_sharding_mesh.py -q -m "not slow"
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_program_store.py -q -k mesh
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_sharding_mesh.py -q -m slow
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_engine_faults.py -q -m chaos

# decode-path drills (ISSUE 17): fused-sampler byte-identity + ragged
# paged-sweep exactness (tier-1 grid and the wider slow resume matrix),
# the paged-KV op suite, the pipelined/bench legs that carry the
# sampled-client mix — under runtime lockdep, since the engine's
# dispatch loop owns the lock order the sampled traffic exercises
decode:
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_sampling_fused.py tests/test_paged_kv.py -q -m "not slow"
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_sampling_fused.py tests/test_pipelined.py -q -m slow
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest "tests/test_bench_smoke.py::TestPipelinedLeg" -q -m slow

# multi-tier live-state drills (ISSUE 18): content keying + tier-store
# units, pool demote-on-unload / promote-on-load, the injected
# RESOURCE_EXHAUSTED recovery drill, the bench tier-swap leg, and the
# eviction-race / seeded mid-demotion chaos matrix — everything under
# runtime lockdep, since demotion adds the tier store's lock to the
# pool's established free-outside-the-lock order
tiers:
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_tiers.py \
		"tests/test_bench_smoke.py::TestTierSwapLeg" -q
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_tiers.py -q -m chaos

# control-plane brownout drills (ISSUE 19): pinned-manifest cache +
# health units, multi-endpoint failover / hedging, offline pull +
# swap-in, durable outbox + drainer, the seeded RegistryKillSwitch
# brownout matrix, the bench outage leg — then the registry-killed-
# under-traffic chaos soak. All under runtime lockdep: the outbox
# drainer and health tracker add locks to the pool's order.
outage:
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_outage.py \
		tests/test_retry.py "tests/test_bench_smoke.py::TestRegistryOutageLeg" -q
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_outage.py -q -m chaos

# two layers: the project-native concurrency/purity gate (always — it is
# stdlib-only and baseline-governed, see docs/analysis.md), then generic
# style via ruff when available
lint:
	$(PY) -m modelx_tpu.analysis
	@if $(PY) -m ruff --version >/dev/null 2>&1; then \
		$(PY) -m ruff check modelx_tpu tests bench.py; \
	else \
		echo "ruff unavailable; falling back to compileall"; \
		$(PY) -m compileall -q modelx_tpu; \
	fi

# the PyTorch/CUDA port's gate: the same six-rule lint over
# modelx_tpu_torch/ and its card scripts, with the port's own baseline
# (modelx_tpu_torch/analysis/baseline.toml); stdlib-only, no torch import
lint-torch:
	$(PY) -m modelx_tpu_torch.analysis

# the port's chaos sweeps (tests/test_torch_*.py, marked chaos + slow)
# under the port's runtime lockdep; a lock-order cycle fails the run. The
# port's plugin is loaded here with -p: tests/conftest.py registers the
# JAX package's, and the port's plugin keeps that one from installing a
# second graph (modelx_tpu_torch/analysis/pytest_lockdep.py)
chaos-torch:
	MODELX_LOCKDEP=1 JAX_PLATFORMS=cpu $(PY) -m pytest -p modelx_tpu_torch.analysis.pytest_lockdep \
		tests/test_torch_*.py -q -m chaos

wheel:
	$(PY) -m pip wheel --no-deps -w dist .

image:
	docker build -t $(IMAGE):$(TAG) -f Dockerfile .

image-dl:
	docker build -t $(IMAGE)-dl:$(TAG) -f Dockerfile.dl .

compose-up:
	docker compose up -d

compose-down:
	docker compose down -v

bench:
	$(PY) bench.py

clean:
	rm -rf dist build *.egg-info
