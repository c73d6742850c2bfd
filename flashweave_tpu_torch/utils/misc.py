"""Host helpers shared with the JAX package.

``flashweave_tpu.utils.misc`` is numpy-only (level counting, weight and
graph assembly), so the port reuses it as it is."""

from flashweave_tpu.utils.misc import *  # noqa: F401,F403
