"""Helpers shared by the ``test_torch_port_*`` files: JAX variables with
non-trivial BatchNorm statistics, as numpy trees the port's converter
takes."""

import jax
import numpy as np


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def randomize_bn(variables, seed=0):
    """Copy of ``variables`` (numpy) whose BatchNorm gammas, betas, running
    means and variances are random, so that eval-mode normalisation
    matters in a parity test."""
    rng = np.random.default_rng(seed)
    out = numpy_tree(variables)

    def visit(params, stats):
        for key, value in params.items():
            if not isinstance(value, dict):
                continue
            if key in stats and "mean" in stats[key]:
                n = value["scale"].shape
                value["scale"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
                value["bias"] = rng.normal(0, 0.05, n).astype(np.float32)
                stats[key]["mean"] = rng.normal(0, 0.05, n).astype(
                    np.float32)
                stats[key]["var"] = rng.uniform(0.6, 1.4, n).astype(
                    np.float32)
            else:
                visit(value, stats.get(key, {}))

    visit(out["params"], out["batch_stats"])
    return out


def jax_init(module, x, **kw):
    """Jitted ``module.init`` (eager init dispatches op by op and is slow)."""
    return jax.jit(lambda k, x: module.init({"params": k}, x, train=False,
                                            **kw))(jax.random.PRNGKey(0), x)
