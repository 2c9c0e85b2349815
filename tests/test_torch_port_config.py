"""The port's config parser on the TPU-only ``PERFORMANCE`` keys: it
parses them, as the JAX package does, warns once that it ignores them, and
stays silent on a config that names none of them."""

import os
import warnings

import pytest

pytest.importorskip("torch")

from embeddingnet_tpu.config import parse_params as j_parse_params  # noqa
from embeddingnet_tpu_torch.config import (  # noqa: E402
    TPU_ONLY_PERFORMANCE_KEYS, params_from_dict, parse_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "resnet50_batchall_1024.yml")
MINIMAL = {"MODEL": {"backbone_name": "resnet18", "input_shape": [32, 32, 3]},
           "PERFORMANCE": {"compute_dtype": "bfloat16", "bn_momentum": 0.9}}


def _ignored_warnings(record):
    return [str(w.message) for w in record
            if issubclass(w.category, UserWarning)
            and "PERFORMANCE keys" in str(w.message)]


def test_flagship_config_warns_once_and_parses_as_jax_does():
    with pytest.warns(UserWarning) as record:
        params = parse_params(FLAGSHIP)
    messages = _ignored_warnings(record)
    assert len(messages) == 1, messages
    assert "'donate_state'" in messages[0]
    assert "'use_pallas_mining'" in messages[0]
    assert "'param_packing'" not in messages[0]   # the flagship omits it
    assert "ignores them" in messages[0]
    # parsed all the same, to the JAX package's values
    jax_params = j_parse_params(FLAGSHIP)
    for key in TPU_ONLY_PERFORMANCE_KEYS:
        assert params.performance[key] == jax_params.performance[key]


@pytest.mark.parametrize("key", TPU_ONLY_PERFORMANCE_KEYS)
def test_each_tpu_only_key_warns(key):
    cfg = {**MINIMAL, "PERFORMANCE": {**MINIMAL["PERFORMANCE"], key: False}}
    with pytest.warns(UserWarning) as record:
        params = params_from_dict(cfg)
    messages = _ignored_warnings(record)
    assert len(messages) == 1 and f"'{key}'" in messages[0], messages
    assert params.performance[key] is False


def test_config_without_tpu_only_keys_does_not_warn():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        params = params_from_dict(MINIMAL)
        params_from_dict({})
    assert params.performance.bn_momentum == 0.9
