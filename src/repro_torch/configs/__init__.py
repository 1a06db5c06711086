# The ten assigned architectures' configurations (one function a file, the
# port's copies of repro.configs) and the registry that maps --arch to a
# configuration and its model functions.
from .registry import (ARCHS, abstract_params, exact_active_param_count,
                       exact_param_count, get_config, init_params,
                       make_decode_fn, make_loss_fn, make_prefill_fn,
                       make_train_batch, model_module, train_input_specs)
