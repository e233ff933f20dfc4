"""PyTorch port: the CLI's --backend blocked (the blocked varcol scene, its plain torch reference (the JAX
package's XLA reference)) against the JAX
CLI: --set_target on the procedural sphere and on the asset body, and two
L-BFGS iterations on the asset body, under the tolerances and on the
inputs of tests/test_torch_cli.py."""

from tests.test_torch_cli import (N_BLOB, N_SPHERE, NAME, bases,  # noqa: F401
                                  check_targets, lbfgs_both, targets)


def test_set_target_matches_jax(targets):
    check_targets(targets("sphere", "blocked"), NAME, N_SPHERE)
    check_targets(targets("blob", "blocked"), "blob", N_BLOB)


def test_lbfgs_matches_jax(tmp_path, targets, bases):
    lbfgs_both(tmp_path, targets, bases, "blocked")
