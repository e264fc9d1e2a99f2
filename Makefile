# Build system, mirroring the reference's Makefile targets
# (reference Makefile:18-46: all / dep / build / docker-build / gofmt /
# test / render-circle). The Go static binary's analogue is a stdlib
# zipapp: one self-contained executable file under bin/.

PYTHON      ?= python3
APP         := downloader
BINDIR      := bin
DOCKER_IMAGE ?= downloader-tpu
# the PyTorch/CUDA port (downloader_tpu_torch): its zipapp and its image
TORCH_APP   := downloader-torch
CUDA_IMAGE  ?= downloader-tpu-torch

.PHONY: all dep build native wheel docker-build fmt fmt-fix analyze analyze-full test bench clean \
	dep-torch native-torch kernel-torch build-torch analyze-torch docker-build-cuda \
	failpoints-torch profile-torch bench-torch

all: dep native build

# Native RC4 core for MSE peer encryption (fetch/_rc4.c). The loader
# (fetch/rc4_native.py) also compiles this lazily at first use and
# falls back to pure Python, so this target is an optimization: build
# ahead of time (e.g. in the Docker image) so the first encrypted peer
# connection doesn't pay the compile.
native:
	@if command -v cc >/dev/null 2>&1; then \
	  cc -O2 -shared -fPIC -o downloader_tpu/fetch/_rc4.so downloader_tpu/fetch/_rc4.c && \
	  echo "built downloader_tpu/fetch/_rc4.so"; \
	else \
	  echo "native: no C compiler; MSE RC4 will use the pure-Python fallback"; \
	fi

# The reference's `make dep` fetches Go modules (Makefile:31-33). Runtime
# deps here are stdlib-only (jax optional); this just verifies the tree
# imports cleanly so breakage is caught before packaging.
dep:
	$(PYTHON) -c "import downloader_tpu, downloader_tpu.cli"

# Single-file executable (zipapp), the static-binary analogue
# (reference Makefile:24-28 builds bin/downloader with -ldflags '-w -s').
build: native
	rm -rf $(BINDIR)/.staging
	mkdir -p $(BINDIR)/.staging
	cp -r downloader_tpu $(BINDIR)/.staging/
	find $(BINDIR)/.staging -name '__pycache__' -type d -exec rm -rf {} +
	# _rc4.so ships INSIDE the archive: ctypes can't load from a zip,
	# so rc4_native extracts it to a per-user cache dir on first use
	# (content-hash keyed); compiler-less hosts then still get native
	# MSE speed from the shipped single file. Never ship a stale
	# binary that doesn't even load HERE (e.g. carried over from a
	# different-arch build tree) — the runtime falls back to
	# compiling the shipped source, but a known-bad .so is dead weight
	@if [ -f $(BINDIR)/.staging/downloader_tpu/fetch/_rc4.so ] && \
	  ! $(PYTHON) -c "import ctypes; ctypes.CDLL('$(BINDIR)/.staging/downloader_tpu/fetch/_rc4.so')" 2>/dev/null; then \
	  rm -f $(BINDIR)/.staging/downloader_tpu/fetch/_rc4.so; \
	  echo "dropped unloadable _rc4.so from the archive"; \
	fi
	printf 'from downloader_tpu.cli import main\nimport sys\nsys.exit(main())\n' \
	  > $(BINDIR)/.staging/__main__.py
	$(PYTHON) -m zipapp $(BINDIR)/.staging -o $(BINDIR)/$(APP).pyz \
	  -p "/usr/bin/env python3" -c
	rm -rf $(BINDIR)/.staging
	@echo "built $(BINDIR)/$(APP).pyz"

wheel:
	$(PYTHON) -m build --wheel --no-isolation --outdir $(BINDIR)/

# The port. Its imports need torch (the wheel's `gpu` extra).
dep-torch:
	$(PYTHON) -c "import downloader_tpu_torch, downloader_tpu_torch.cli, torch"

# The port's RC4 core, beside its source, as `native` builds the JAX
# package's; rc4_native.py also compiles it at first use.
native-torch:
	@if command -v cc >/dev/null 2>&1; then \
	  cc -O2 -shared -fPIC -o downloader_tpu_torch/fetch/_rc4.so downloader_tpu_torch/fetch/_rc4.c && \
	  echo "built downloader_tpu_torch/fetch/_rc4.so"; \
	else \
	  echo "native-torch: no C compiler; MSE RC4 will use the pure-Python fallback"; \
	fi

# The CUDA SHA-1 kernel for sm_90a (needs nvcc), compiled by the module
# with its own NVCC_FLAGS into the directory a checkout loads it from;
# sha1_cuda.py also compiles it there at first use.
kernel-torch:
	$(PYTHON) -m downloader_tpu_torch.parallel --out build/downloader_tpu_torch

# bin/downloader-torch.pyz: the port alone, with _rc4.so when a C
# compiler exists and the kernel library when nvcc does
# (hack/build_torch_pyz.py builds both into the archive itself).
build-torch:
	$(PYTHON) hack/build_torch_pyz.py --out $(BINDIR)/$(TORCH_APP).pyz

# The port's image, for Hopper (sm_90a) only: Dockerfile.cuda.
docker-build-cuda:
	docker build -f Dockerfile.cuda -t $(CUDA_IMAGE) .

docker-build:
	docker build -t $(DOCKER_IMAGE) .

# gofmt analogue (reference Makefile:35-37). No third-party formatter is
# assumed; hack/fmt.py enforces whitespace/newline/tab hygiene with the
# stdlib tokenizer. `make fmt` checks, `make fmt-fix` rewrites.
FMT_PATHS := downloader_tpu downloader_tpu_torch tests bench.py __graft_entry__.py chip_smoke.py hack/build_torch_pyz.py hack/pipeline_torch.py hack/fleet_torch.py hack/failpoint_matrix_torch.py hack/profile_artifacts_torch.py hack/multicard_torch.py bench_torch.py bench_digest_torch.py __graft_entry_torch__.py

fmt:
	$(PYTHON) hack/fmt.py $(FMT_PATHS)

fmt-fix:
	$(PYTHON) hack/fmt.py --fix $(FMT_PATHS)

# Concurrency & resource-safety static analysis (go vet analogue):
# the CFG/dataflow/summary rule set — guarded-by, no-blocking-under-
# lock, resource-finalization, lock-order, lock-balance, exception-
# hygiene, protocol typestate, blocking-deadline, thread-role-race,
# env-knob-documented — interprocedural over the whole package. Also
# enforced inside the test suite (tests/test_static_analysis.py);
# this target is the standalone pre-commit entry point. Re-runs are
# cheap: unchanged files adopt their mtime-keyed cached scans and a
# no-change run replays in ~0.6s (CI uses --no-cache and emits the
# call graph + effect summary table beside the violation report —
# `make analyze-artifacts` does the same locally, paying a live pass
# because the artifact needs the program built).
# `make analyze-diff REF=main` reports only on files changed vs REF
# plus their reverse call-graph dependents.
REF ?= HEAD
analyze:
	$(PYTHON) -m downloader_tpu.analysis

analyze-diff:
	$(PYTHON) -m downloader_tpu.analysis --diff $(REF)

analyze-artifacts:
	$(PYTHON) -m downloader_tpu.analysis --emit-summary .analysis-summary.json

analyze-full:
	$(PYTHON) -m downloader_tpu.analysis --no-cache

# the port's own analyzer over downloader_tpu_torch/ (its cache is
# .analysis-cache-torch.json)
analyze-torch:
	$(PYTHON) -m downloader_tpu_torch.analysis

# the port's chaos and profiling tooling, as CI runs it: the per-seed
# failpoint matrix (failpoint_matrix.json) and the profiling artifacts
# (bench.collapsed, bench.svg, profile.json) into OUT
failpoints-torch:
	$(PYTHON) hack/failpoint_matrix_torch.py $(or $(OUT),/tmp/failpoints-torch)

profile-torch:
	$(PYTHON) hack/profile_artifacts_torch.py $(or $(OUT),/tmp/profile-torch) $(or $(JOBS),300)

test:
	$(PYTHON) -m pytest tests/ -q

bench:
	$(PYTHON) bench.py

# the port's end-to-end benchmark, bench.py's twin; its digest arm needs
# a CUDA card (BENCH_DIGEST=0 runs the host arms alone)
bench-torch:
	$(PYTHON) bench_torch.py

clean:
	rm -rf $(BINDIR) build dist *.egg-info
