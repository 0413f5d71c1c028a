PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH))

.PHONY: test test-fast lint lint-torch bench-throughput bench-step bench-engine bench-recall bench-recall-full bench-walk bench-sanitize bench-attr bench-trace bench-check

test:
	PYTHONPATH=$(PYTHONPATH) python -m pytest -x -q

test-fast:
	PYTHONPATH=$(PYTHONPATH) python -m pytest -q -m quick

lint:
	PYTHONPATH=$(PYTHONPATH) python -m repro.lint

# the PyTorch port's contract checker (docs/lint_torch.md)
lint-torch:
	PYTHONPATH=$(PYTHONPATH) python -m repro_torch.lint

bench-throughput:
	PYTHONPATH=$(PYTHONPATH) python benchmarks/bench_throughput.py --quick

bench-step:
	PYTHONPATH=$(PYTHONPATH) python benchmarks/bench_throughput.py --step

bench-engine:
	PYTHONPATH=$(PYTHONPATH) python benchmarks/bench_throughput.py --engine

bench-recall:
	PYTHONPATH=$(PYTHONPATH) python benchmarks/bench_recall.py --quick

# adds the 10M-item arm (device-resident int8 index, host re-rank) + more reps
bench-recall-full:
	PYTHONPATH=$(PYTHONPATH) python benchmarks/bench_recall.py --full

bench-walk:
	PYTHONPATH=$(PYTHONPATH) python benchmarks/bench_throughput.py --walk --full

bench-sanitize:
	PYTHONPATH=$(PYTHONPATH) python benchmarks/bench_throughput.py --sanitize

bench-attr:
	PYTHONPATH=$(PYTHONPATH) python benchmarks/bench_throughput.py --attribution

bench-trace:
	PYTHONPATH=$(PYTHONPATH) python benchmarks/bench_throughput.py --telemetry

# perf-regression gate: fresh quick arms vs the committed BENCH JSONs
# (direction-aware tolerance bands; exit 1 on non-baselined regressions)
bench-check:
	PYTHONPATH=$(PYTHONPATH) python benchmarks/regression.py
