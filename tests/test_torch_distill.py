"""Port parity: ZipVoiceDistill sampling (zipvoice_torch) vs the JAX
package, f32 on CPU, at fixed noise."""

import pytest

import conftest  # noqa: F401

from torch_parity import (  # noqa: F401
    assert_sample_matches,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_sample_distill_matches_jax():
    """The guidance scale is a network input; no batch doubling."""
    assert_sample_matches(True, 3.0)
