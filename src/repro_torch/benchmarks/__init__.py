"""The port's benchmark sections: the paper-figure drivers (Fig. 2-5) and
the JAX package's nine service suites, on ``repro_torch``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [section ...] [--smoke]

Each section prints the JAX package's ``name,us_per_call,derived`` rows and
runs on the card (``device=None``); its functions also take
``device="cpu"``, which runs each kernel's plain PyTorch version.
``regress`` compares two runs' ``BENCH_torch_*.json``.
"""
