from anyedit_tpu_torch.diffusion.ip2p import (
    ip2p_edit, noise_diff_heatmap, predict_edit_mask,
)
