# Tests run on the CPU: JAX_PLATFORMS=cpu, and conftest.py gives the CPU
# backend 8 virtual devices for the sharding tests.
# On a GPU host, plain `python` uses the card.  Keep to one JAX process per
# card: a process reserves most of the card's memory when it starts.
#   python chip_smoke.py             # end-to-end proof on one card
#   python chip_smoke.py --chips 4   # chunk workers and sharding, 4 cards

PY := env PYTHONPATH=$(CURDIR) JAX_PLATFORMS=cpu python

# host C helpers; the loaders also build these on first use
native:
	$(PY) -c "from smcsmc_tpu import _native; _native.build('segscan'); _native.build('lookahead')"

test:
	$(PY) -m pytest tests/ -x -q -m "not slow"

test-all:
	$(PY) -m pytest tests/ -x -q

bench:
	python bench.py

# device tier: the gpu-marked tests, in one process on the card.
# SMCSMC_BIG_GATES=1 adds the opt-in 30 Mb split gate.
gpu-tests:
	env PYTHONPATH=$(CURDIR) SMCSMC_GPU_TESTS=1 python -m pytest tests/test_gpu_smoke.py tests/test_gpu_stat_gates.py -x -q

.PHONY: test test-all bench native gpu-tests
