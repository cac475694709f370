from anyedit_tpu_torch.core.config import CanvasConfig
from anyedit_tpu_torch.core.schema import InstructionRecord, read_records, write_records
