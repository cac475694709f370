from anyedit_tpu_torch.core.config import CanvasConfig
