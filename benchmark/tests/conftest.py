"""The benchmark's CPU tests: JAX runs on the CPU here, whatever the
machine holds."""

import os

os.environ['JAX_PLATFORMS'] = 'cpu'
