# Frozen copy of youreditableavatar_tpu_torch/utils/schedule.py (the plain PyTorch path only).
"""Step-interpolated hyperparameter schedules (the reference's ``C()`` mini-language).

Capability parity with `tetgs_spatial/utils/misc.py:65-86`: a scheduled value is
either a scalar (constant) or a 4-list ``[start_step, start_value, end_value,
end_step]`` linearly interpolated in ``step`` (or in ``epoch`` when the list is
prefixed with the string ``"epoch"``). Used for SDS timestep-range annealing and
loss-weight warmups.
"""

from __future__ import annotations

from typing import Any, List, Union

ScheduleSpec = Union[int, float, List[Any]]


def C(value: ScheduleSpec, epoch: int, global_step: int) -> float:
    """Evaluate a scheduled hyperparameter at (epoch, global_step)."""
    if isinstance(value, (int, float)):
        return float(value)
    if not isinstance(value, (list, tuple)):
        raise TypeError(f"scalar or schedule list expected, got {type(value)}")

    value = list(value)
    interp_in_epoch = False
    if len(value) >= 1 and value[0] == "epoch":
        interp_in_epoch = True
        value = value[1:]
    if len(value) == 3:
        # [start_value, end_value, end_step] shorthand: starts at step/epoch 0.
        value = [0] + value[:]
        # Reference order for len-3 is [start_val, end_val, end_step].
        start_step, start_value, end_value, end_step = 0, value[1], value[2], value[3]
    elif len(value) == 4:
        start_step, start_value, end_value, end_step = value
    else:
        raise ValueError(f"schedule list must have 3 or 4 entries, got {value}")

    t = float(epoch if interp_in_epoch else global_step)
    if end_step == start_step:
        return float(end_value if t >= end_step else start_value)
    frac = (t - start_step) / (end_step - start_step)
    frac = min(1.0, max(0.0, frac))
    return float(start_value) + frac * (float(end_value) - float(start_value))
