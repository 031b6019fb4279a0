from unetdc_tpu_torch.checkpoint.convert import (  # noqa: F401
    load_pth_state_dict,
    torch_state_dict_to_variables,
    variables_to_state_dict,
    variables_to_torch_state_dict,
)
