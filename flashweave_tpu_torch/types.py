"""Result and search-state types, shared with the JAX package.

``flashweave_tpu.types`` is numpy-only (it imports no jax), so the port uses
the very same classes: a network learned by either package is the same
``Graph`` / ``FWResult`` type and compares directly."""

from flashweave_tpu.types import *  # noqa: F401,F403
