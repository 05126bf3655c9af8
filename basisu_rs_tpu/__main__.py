"""`python -m` under the package's former name: runs basisu_rs_jax's CLI."""

import sys

from basisu_rs_jax.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
