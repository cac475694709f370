"""DPM-Solver++(2M) and PLMS as step functions whose multistep history is
explicit carry state (counterpart of `anyedit_tpu/schedulers/dpm.py`;
reference: ldm's dpm_solver.py and PLMSSampler).

DPM-Solver++(2M): data-prediction multistep in log-SNR (lambda) time.
PLMS: pseudo linear multistep over eps (Adams-Bashforth up to 4th order)
with the DDIM update on the averaged eps. The JAX steps select the order
with `jnp.where` on the carried counters; here the counters are read on the
host and select the branch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from anyedit_tpu_torch.schedulers.common import NoiseSchedule, pred_x0, spaced_timesteps


class DPMState(NamedTuple):
    timesteps: torch.Tensor  # (S,) descending
    alphas: torch.Tensor     # (S + 1,) sqrt(acp), the final level included
    sigmas: torch.Tensor     # (S + 1,)
    lambdas: torch.Tensor    # (S + 1,) log(alpha / sigma)


def dpm_init(ns: NoiseSchedule, num_inference_steps: int) -> DPMState:
    acp_all = ns.alphas_cumprod
    ts = spaced_timesteps(ns.num_train_steps, num_inference_steps, device=acp_all.device)
    step = ns.num_train_steps // num_inference_steps
    acp_next = acp_all[torch.clamp(ts - step, min=0)]
    acp = torch.cat([acp_all[ts], acp_next[-1:]])
    alphas, sigmas = torch.sqrt(acp), torch.sqrt(1.0 - acp)
    lambdas = torch.log(torch.clamp(alphas, min=1e-10)) - torch.log(torch.clamp(sigmas, min=1e-10))
    return DPMState(ts, alphas, sigmas, lambdas)


class DPMCarry(NamedTuple):
    prev_x0: torch.Tensor    # the previous step's x0 prediction
    has_prev: torch.Tensor   # 0-dim, 0. or 1.


def dpm_carry_init(shape, device=None) -> DPMCarry:
    return DPMCarry(torch.zeros(shape, device=device), torch.zeros((), device=device))


def dpm_step(ns: NoiseSchedule, st: DPMState, i: int, model_out: torch.Tensor,
             sample: torch.Tensor, carry: DPMCarry) -> tuple[torch.Tensor, DPMCarry]:
    """One DPM-Solver++(2M) update at loop index i (0 = highest noise)."""
    x = sample.float()
    x0, _ = pred_x0(ns, model_out.float(), x, st.timesteps[i])
    lam_t, lam_n, lam_p = st.lambdas[i], st.lambdas[i + 1], st.lambdas[max(i - 1, 0)]
    h = lam_n - lam_t
    # the 2M correction when a previous x0 exists, else first order (DPM++ 1S)
    if float(carry.has_prev) > 0 and i > 0:
        r = torch.clamp((lam_t - lam_p) / torch.clamp(h, min=1e-10), min=1e-10)
        d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * carry.prev_x0
    else:
        d = x0
    sig_t, sig_n, alp_n = st.sigmas[i], st.sigmas[i + 1], st.alphas[i + 1]
    prev = (sig_n / torch.clamp(sig_t, min=1e-10)) * x - alp_n * torch.expm1(-h) * d
    return prev.to(sample.dtype), DPMCarry(x0, torch.ones((), device=x.device))


class PLMSCarry(NamedTuple):
    eps_hist: torch.Tensor   # (4, ...) the previous eps, newest first
    n_hist: torch.Tensor     # 0-dim int count


def plms_carry_init(shape, device=None) -> PLMSCarry:
    return PLMSCarry(torch.zeros((4,) + tuple(shape), device=device),
                     torch.zeros((), dtype=torch.int32, device=device))


def plms_step(ns: NoiseSchedule, st: DPMState, i: int, model_out: torch.Tensor,
              sample: torch.Tensor, carry: PLMSCarry) -> tuple[torch.Tensor, PLMSCarry]:
    """PLMS: the Adams-Bashforth average of the eps history (order 1 to 4
    as the history fills), then the deterministic DDIM transition."""
    x = sample.float()
    _, eps = pred_x0(ns, model_out.float(), x, st.timesteps[i])
    h, n = carry.eps_hist, int(carry.n_hist)
    if n == 0:
        eps_avg = eps
    elif n == 1:
        eps_avg = (3 * eps - h[0]) / 2
    elif n == 2:
        eps_avg = (23 * eps - 16 * h[0] + 5 * h[1]) / 12
    else:
        eps_avg = (55 * eps - 59 * h[0] + 37 * h[1] - 9 * h[2]) / 24
    acp_t, acp_n = st.alphas[i] ** 2, st.alphas[i + 1] ** 2
    x0 = (x - torch.sqrt(1 - acp_t) * eps_avg) / torch.sqrt(acp_t)
    prev = torch.sqrt(acp_n) * x0 + torch.sqrt(1 - acp_n) * eps_avg
    hist = torch.cat([eps[None], h[:3]], dim=0)
    return prev.to(sample.dtype), PLMSCarry(hist, carry.n_hist + 1)
