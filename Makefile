# Convenience targets (the reference built with src/Makefile; here the
# native extension is optional and everything else is pure Python).

PY ?= python

.PHONY: all ext test test-fast test-gpu bench smoke scaling clean

all: ext

ext:
	$(PY) -m cfrk_tpu.io.build_native

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -x --ignore=tests/test_fuzz.py

# On a machine with an NVIDIA GPU.
test-gpu:
	$(PY) -m pytest tests/ -q -m gpu

bench:
	$(PY) bench.py

smoke:
	$(PY) chip_smoke.py

scaling:
	$(PY) tools/scaling_bench.py --cpu

clean:
	rm -rf build cfrk_tpu/io/native/*.so __pycache__ .pytest_cache
