from anyedit_tpu_torch.diffusion.ip2p import (
    ip2p_edit, noise_diff_heatmap, predict_edit_mask,
)
from anyedit_tpu_torch.diffusion.sampling import sample_inpaint
from anyedit_tpu_torch.diffusion.ultraedit import flux_pair, flux_sample, ultraedit_edit
