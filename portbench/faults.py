"""The control and the planted faults that the check has to catch.

Each is a ``make_step(model, params, cell)`` for :func:`harness.run`, in
the place of the program's step:

* :func:`control` — the plain reference computed in float8 e4m3 (every
  matmul operand rounded), the precision below the configurations'
  bfloat16;
* :func:`stale` — the program's step that returns the previous forward's
  logits after its first: a step that leaves its state unchanged;
* :func:`half_batch` — the program's step on the first half of the batch,
  the rest filled with the mean of the computed half's logits;
* :func:`altered_answer` — the program's step with the logits of one
  position (drawn from the tokens) replaced by its neighbour's.
"""

from __future__ import annotations

import torch

from portbench.harness import program_step, reference_of

__all__ = ["FAULTS", "altered_answer", "control", "half_batch", "stale"]


def control(model, params, cell):
    ref = reference_of(cell.config)
    return lambda tokens: ref.forward(params, tokens, cell.config,
                                      precision="fp8")


def stale(model, params, cell):
    step = program_step(model, params, cell)
    last = []

    def run(tokens):
        out = step(tokens)
        if not last:
            last.append(out)
        prev, last[0] = last[0], out
        return prev

    return run


def half_batch(model, params, cell):
    step = program_step(model, params, cell)

    def run(tokens):
        h = max(tokens.shape[0] // 2, 1)
        out = step(tokens[:h])
        rest = out.float().mean(0, keepdim=True).to(out.dtype)
        return torch.cat([out, rest.expand(tokens.shape[0] - h, *out.shape[1:])])

    return run


def altered_answer(model, params, cell):
    step = program_step(model, params, cell)

    def run(tokens):
        out = step(tokens)
        p = int(tokens[0, 0]) % (tokens.shape[1] - 1)
        out[0, p] = out[0, p + 1]
        return out

    return run


FAULTS = {"stale": stale, "half_batch": half_batch,
          "altered_answer": altered_answer}
