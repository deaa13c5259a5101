"""Faults planted in the program's training step, each a step factory in
the place of ``make_train_step`` (``run.main(..., simulate=)``): a
training cell's ``correct`` has to come out false under each.  The control,
by contrast, is the program's own lower-precision path (``control.py``).

* ``state_unchanged``: the step returns the state it was given;
* ``half_tokens``: the second half of each row's labels left out, the mean
  taken over the rest (B is 1: half of the batch's tokens);
* ``no_d_skip``: every SSD block without its D skip (D times 0);
* ``conv_shift``: the depthwise convolution reads its input one step late.
"""

from __future__ import annotations

import contextlib

import torch.nn.functional as F


def _program():
    from repro_torch.train import make_train_step
    return make_train_step


@contextlib.contextmanager
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def state_unchanged(cfg, opt_cfg):
    step = _program()(cfg, opt_cfg)

    def faulty(state, batch):
        return state, step(state, batch)[1]
    return faulty


def half_tokens(cfg, opt_cfg):
    step = _program()(cfg, opt_cfg)

    def faulty(state, batch):
        labels = batch["labels"].clone()
        labels[:, labels.shape[1] // 2:] = -1
        return step(state, dict(batch, labels=labels))
    return faulty


def _in_block(patch):
    """A factory whose step runs with ``patch`` applied to the SSD module
    (forward and recomputation alike)."""
    def factory(cfg, opt_cfg):
        from repro_torch.models import ssm
        step = _program()(cfg, opt_cfg)

        def faulty(state, batch):
            with patch(ssm):
                return step(state, batch)
        return faulty
    return factory


def _without_d(ssm):
    epilogue = ssm._ssm_epilogue
    return _patched(ssm, "_ssm_epilogue",
                    lambda p, *a, **kw: epilogue(dict(p, D=p["D"] * 0), *a, **kw))


def _conv_late(ssm):
    conv = ssm._conv_mix
    return _patched(ssm, "_conv_mix",
                    lambda p, xbc, cfg: conv(p, F.pad(xbc, (0, 0, 1, 0))[:, :-1], cfg))


no_d_skip = _in_block(_without_d)
conv_shift = _in_block(_conv_late)
FAULTS = {"state_unchanged": state_unchanged, "half_tokens": half_tokens,
          "no_d_skip": no_d_skip, "conv_shift": conv_shift}
