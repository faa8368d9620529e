"""The port's ``ArchConfig`` against the reference's, field by field.

The port's config has every field of the reference's and, beside them, the
fields only the port has (``repro_torch.configs.base.PORT_ONLY_FIELDS``:
granite-4.0-h's NoPE, multipliers and dropless MoE), each with a default
that keeps a registered architecture as the reference has it."""

import dataclasses

from repro_torch.configs.base import PORT_ONLY_FIELDS


def assert_config_equal(port, ref, what=""):
    """Every field of ``ref`` equals the same field of ``port``, the port's
    other fields are exactly the port-only ones, and each holds its
    default."""
    want, got = dataclasses.asdict(ref), dataclasses.asdict(port)
    for name, value in want.items():
        assert got[name] == value, (what, name)
    assert set(got) - set(want) == set(PORT_ONLY_FIELDS), what
    for name, default in PORT_ONLY_FIELDS.items():
        assert got[name] == default, (what, name)
