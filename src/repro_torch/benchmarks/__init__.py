"""The paper-figure drivers (Fig. 2-5) on ``repro_torch.core``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [fig2 ...]

Each driver prints the JAX drivers' ``name,us_per_call,derived`` rows and
runs on the card (``device=None``); its functions also take
``device="cpu"``, which runs each kernel's plain PyTorch version.
"""
