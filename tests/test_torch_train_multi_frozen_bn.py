"""The port's K-steps dispatch with frozen BatchNorm (the SWA epochs'
mode) in fp32 against the JAX package's scan, at 1e-4 of each tensor's
scale; the helpers and the configuration are
tests/test_torch_train_multi.py's (kept in a file of its own so the two
modes' JAX compilations run on two test workers).
"""

from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_resident import synthetic_stores  # noqa: F401  (fixture)
from tests.test_torch_train_multi import check_multi_against_jax


def test_multi_steps_match_jax_frozen_bn_fp32(synthetic_stores):
    check_multi_against_jax(synthetic_stores, True, ("resident", "compact", "dense"))
