"""The rest of a run, with the timed path broken underneath, comes out
not correct: a step that leaves its state unchanged, half of each batch
left out (the mean taken over the rest), a token altered where the
micro-batch is made. The cell's own limits judge a tiny float32 run on
the CPU; the card's absence is the only thing skipped."""
import contextlib
import importlib
from unittest import mock

import pytest

from portbench.tests.tiny import cells, run, tiny_cell


def _unchanged_state(params, grads, state, cfg):
    from repro_torch.train.optimizer import global_norm
    state["step"] += 1
    return params, state, {"grad_norm": global_norm(grads)}


def _half_batch(xent_sums):
    def f(head_w, h, labels, w, cfg):
        w = w.clone()
        w[(w.shape[0] + 1) // 2:] = 0
        return xent_sums(head_w, h, labels, w, cfg)
    return f


def _altered_token(make):
    def f(*a, **kw):
        b = make(*a, **kw)
        key = "enc_tokens" if "enc_tokens" in b else "tokens"
        b[key][0, 1] = (b[key][0, 1] + 1) % 7
        return b
    return f


def _plants(mode):
    from repro_torch.data import dataset
    from repro_torch.dist import backend
    from repro_torch.models import model
    from repro_torch.train import optimizer, runner
    made = ([(runner, "materialize_micro_batch")] if mode == "dynamic" else
            [(dataset, "materialize_packed_rows"),
             (dataset, "materialize_packed_encdec_rows")])
    return {
        "unchanged_state": [mock.patch.object(backend, "adamw_update",
                                              _unchanged_state),
                            mock.patch.object(optimizer, "adamw_update",
                                              _unchanged_state)],
        "half_batch": [mock.patch.object(model, "xent_sums",
                                         _half_batch(model.xent_sums))],
        "altered_token": [mock.patch.object(m, n, _altered_token(getattr(m,
                                                                         n)))
                          for m, n in made],
    }


class _Planted:
    def __init__(self, mode, patches):
        self.mode, self.patches = mode, patches

    def run(self, *a):
        with contextlib.ExitStack() as stack:
            for p in self.patches:
                stack.enter_context(p)
            return self.mode.run(*a)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_token"])
@pytest.mark.parametrize("name", cells())
def test_a_broken_step_is_not_correct(name, fault):
    cell = tiny_cell(name)
    mode = importlib.import_module(f"portbench.modes.{cell.spec['mode']}")
    out = run(cell, mode=_Planted(mode, _plants(cell.spec["mode"])[fault]))
    assert not out["correct"], out["checks"]
