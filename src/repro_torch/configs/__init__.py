# The ten assigned architectures' configurations (one function a file, the
# port's copies of repro.configs) and the registry that maps --arch to a
# configuration and its model functions.
from .registry import (ARCHS, get_config, init_params, make_decode_fn,
                       make_prefill_fn, model_module)
