"""The L2 layer: instruction records from captions (counterpart of
`anyedit_tpu/instructions`)."""

from anyedit_tpu_torch.instructions.generator import (
    InstructionGenerator, rule_based_counting, rule_based_resize_movement,
    rule_based_relation, rule_based_visual_reference,
)
from anyedit_tpu_torch.instructions.prompts import (
    FEW_SHOT_BANK, system_prompt, eval_prompt,
)
from anyedit_tpu_torch.instructions.captions import caption_from_concept
