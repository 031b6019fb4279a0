from unetdc_tpu_torch.checkpoint.convert import (  # noqa: F401
    load_optax_adam_state,
    load_pth_state_dict,
    named_to_params,
    optax_adam_state_dict,
    params_to_named,
    torch_state_dict_to_variables,
    variables_to_state_dict,
    variables_to_torch_state_dict,
)
from unetdc_tpu_torch.checkpoint.native import (  # noqa: F401
    BestMetricCheckpointer,
    load_checkpoint,
    load_metadata,
    save_checkpoint,
)
