from anyedit_tpu_torch.schedulers.common import (
    NoiseSchedule, add_noise, make_noise_schedule, pred_x0, spaced_timesteps, velocity_target,
)
from anyedit_tpu_torch.schedulers.ddim import (
    DDIMState, ddim_init, ddim_inversion_step, ddim_step,
)
from anyedit_tpu_torch.schedulers.ddpm import ddpm_step
from anyedit_tpu_torch.schedulers.euler import (
    EulerState, euler_ancestral_init, euler_ancestral_step,
)
from anyedit_tpu_torch.schedulers.flow import (
    FlowState, flow_add_noise, flow_init, flow_step, flux_mu,
)

SCHEDULERS = ("ddim", "ddpm", "euler_a", "flow", "dpm++2m", "plms")
