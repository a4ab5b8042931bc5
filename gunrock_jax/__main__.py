"""``python -m gunrock_jax <primitive> ...`` — see :mod:`gunrock_jax.cli`."""

import sys

from .cli import main

sys.exit(main())
