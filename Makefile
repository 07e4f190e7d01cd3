# Convenience targets (see CLAUDE.md for environment notes)

.PHONY: test bench bench-all native figures dryrun docs docs-torch figures-torch \
	dryrun-torch

docs:
	python docs/gen_api.py

# The PyTorch/CUDA port: its API reference (docs/api_torch/), its figures
# (the card by default; DEVICE=cpu for the CPU) and its dry run on gloo ranks.
docs-torch:
	python docs/gen_api_torch.py

test:
	python -m pytest tests/ -q

bench:
	python bench.py

bench-all:
	python bench.py
	python bench.py --config blr
	python bench.py --config hier
	python bench_scaling.py

native:
	$(MAKE) -C native

figures:
	python examples/plot_results.py

dryrun:
	python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

figures-torch:
	python examples/torch_plot_results.py --device $(or $(DEVICE),cuda)

dryrun-torch:
	python -m svgdcpp_tpu_torch.parallel.dryrun 8
