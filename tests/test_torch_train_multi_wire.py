"""The port's K-steps dispatch on the wire feeds (compact, and dense on
the maps the device renderer draws from the same joints) against the JAX
package's compact scan, train-mode BatchNorm in float64 at 1e-6 of each
tensor's scale; the helpers and the configuration are
tests/test_torch_train_multi.py's (kept in a file of its own so that the
JAX compilations run on several test workers).
"""

from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_resident import synthetic_stores  # noqa: F401  (fixture)
from tests.test_torch_train_multi import check_multi_against_jax


def test_multi_wire_steps_match_jax_train_bn_float64(synthetic_stores):
    check_multi_against_jax(synthetic_stores, False, ("compact", "dense"))
