"""Faults planted under the timed path, for the checks that the
comparison deciding `correct` catches them (the tests, and `calibrate.py`
on the chip). The benchmark's runs never use them.

* `state_unchanged`: every optimizer step returns the weights unchanged;
* `half_batch`: the model sees only the first half of each batch's rows,
  so each mean is taken over the rest;
* and the faults of the cell's family (`families/<family>.py`,
  `FAULTS`), such as an answer altered where it is produced.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def state_unchanged(family):
    with mock.patch.object(torch.optim.AdamW, "step",
                           lambda self, closure=None: None):
        yield


@contextlib.contextmanager
def half_batch(family):
    cls = family.model_class()
    forward = cls.forward

    def halved(self, *args, **kw):
        h = max(args[0].shape[0] // 2, 1)
        return forward(self, *(a[:h] for a in args), **kw)

    with mock.patch.object(cls, "forward", halved):
        yield


GENERAL = {"state_unchanged": state_unchanged, "half_batch": half_batch}


def plant(name: str, cell):
    """The context under which the fault `name` breaks `cell`'s program."""
    family = cell.family()
    if name in GENERAL:
        return GENERAL[name](family)
    return family.FAULTS[name]()
