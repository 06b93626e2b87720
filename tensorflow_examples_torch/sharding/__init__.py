"""The placement subsystem: the port of ``tensorflow_examples_tpu/sharding/``.

One serializable :class:`ShardingConfig` is the source of truth for
placement: ``train/loop.Trainer`` builds its mesh, its parameter and
optimizer layout and its ZeRO-1 policy from it, and persists it as
``workdir/sharding.json`` (the reference's JSON schema), so a resume on
another mesh shape reshards and a drifted rules table fails with
:class:`ShardingMismatchError`. ``core/mesh.py`` owns the axes,
``core/sharding.py`` the rules table; ``resolve.py`` turns both into a
placement table, a digest and byte totals.
"""

from tensorflow_examples_torch.sharding.config import (ShardingConfig, ShardingMismatchError,
                                                       spec_from_json, spec_to_json)
from tensorflow_examples_torch.sharding.resolve import (ResolvedSharding, resolve_params,
                                                        state_shardings, verify_digest_agreement,
                                                        zero1_spec)

__all__ = ["ResolvedSharding", "ShardingConfig", "ShardingMismatchError", "resolve_params",
           "spec_from_json", "spec_to_json", "state_shardings", "verify_digest_agreement",
           "zero1_spec"]
