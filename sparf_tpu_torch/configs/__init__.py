from sparf_tpu_torch.configs.config import ConfigDict, override_options, load_options, save_options_file  # noqa: F401
from sparf_tpu_torch.configs import default  # noqa: F401
