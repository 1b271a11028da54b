# Copied from src/repro/comms/link.py; imports rebound to repro_torch.
"""Satellite <-> GS RF link budget (paper eqs. 5-8 and 13-16).

All formulas follow the paper:

  SNR(k, GS) = P_t G_k G_GS / (K_B T B L_{k,GS})                       (5)
  L_{k,GS}   = (4 pi d f / c)^2                                        (6)
  t_c        = t_t + t_p + t_k + t_GS,  t_t = z|N|/R,  t_p = d/c       (7)
  R          ~ B log2(1 + SNR)                                         (8)

and the resource-block split of §IV-B: the uplink (GS -> satellites,
global-model broadcast) uses the full bandwidth B = N * B_D while each
sink satellite competes for one RB of bandwidth B_D on the downlink
(eqs. 13-16).

Table I parameters are the defaults.
"""
from __future__ import annotations

import dataclasses
import math

K_BOLTZMANN = 1.380649e-23
C_LIGHT = 299_792_458.0


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """RF link parameters (paper Table I, upper part)."""

    tx_power_dbm: float = 40.0          # P_t (satellite & GS)
    antenna_gain_dbi: float = 6.98      # G_k and G_GS
    carrier_freq_hz: float = 2.4e9      # f
    noise_temp_k: float = 354.81        # T
    bandwidth_hz: float = 1.0e6         # B (full uplink bandwidth)
    num_resource_blocks: int = 8        # N, with B = N * B_D
    data_rate_bps: float = 16.0e6       # R: max transmission data rate
    processing_delay_s: float = 0.0     # t_k + t_GS (omitted per paper)

    @property
    def rb_bandwidth_hz(self) -> float:
        """B_D: per-resource-block downlink bandwidth."""
        return self.bandwidth_hz / self.num_resource_blocks

    @property
    def tx_power_w(self) -> float:
        return 10.0 ** ((self.tx_power_dbm - 30.0) / 10.0)

    @property
    def antenna_gain_linear(self) -> float:
        return 10.0 ** (self.antenna_gain_dbi / 10.0)


def free_space_path_loss(distance_m: float, freq_hz: float) -> float:
    """Eq. (6): L = (4 pi d f / c)^2 (linear)."""
    return (4.0 * math.pi * distance_m * freq_hz / C_LIGHT) ** 2


def snr_linear(
    cfg: LinkConfig, distance_m: float, bandwidth_hz: float | None = None
) -> float:
    """Eq. (5): SNR = P_t G_k G_GS / (K_B T B L) (linear)."""
    b = cfg.bandwidth_hz if bandwidth_hz is None else bandwidth_hz
    loss = free_space_path_loss(distance_m, cfg.carrier_freq_hz)
    noise = K_BOLTZMANN * cfg.noise_temp_k * b
    return (cfg.tx_power_w * cfg.antenna_gain_linear**2) / (noise * loss)


def snr_db(
    cfg: LinkConfig, distance_m: float, bandwidth_hz: float | None = None
) -> float:
    """Eqs. (13)/(14) expressed in dB."""
    return 10.0 * math.log10(snr_linear(cfg, distance_m, bandwidth_hz))


def shannon_rate(
    cfg: LinkConfig, distance_m: float, bandwidth_hz: float | None = None
) -> float:
    """Eq. (8): R ~ B log2(1 + SNR), capped by the configured max rate."""
    b = cfg.bandwidth_hz if bandwidth_hz is None else bandwidth_hz
    rate = b * math.log2(1.0 + snr_linear(cfg, distance_m, b))
    return min(rate, cfg.data_rate_bps)


def transmission_time(payload_bits: float, rate_bps: float) -> float:
    """t_t = z|N| / R."""
    return payload_bits / rate_bps


def propagation_time(distance_m: float) -> float:
    """t_p = d / c."""
    return distance_m / C_LIGHT


def model_exchange_time(
    cfg: LinkConfig,
    payload_bits: float,
    distance_m: float,
    bandwidth_hz: float | None = None,
) -> float:
    """Eq. (7): t_c = t_t + t_p + t_k + t_GS over a link of given bandwidth."""
    rate = shannon_rate(cfg, distance_m, bandwidth_hz)
    return (
        transmission_time(payload_bits, rate)
        + propagation_time(distance_m)
        + cfg.processing_delay_s
    )


def uplink_time(cfg: LinkConfig, payload_bits: float, distance_m: float) -> float:
    """Eq. (15): t_c^U — GS broadcast of the global model over full B."""
    return model_exchange_time(cfg, payload_bits, distance_m, cfg.bandwidth_hz)


def downlink_time(cfg: LinkConfig, payload_bits: float, distance_m: float) -> float:
    """Eq. (16): t_c^D — sink upload of the partial model over one RB (B_D)."""
    return model_exchange_time(cfg, payload_bits, distance_m, cfg.rb_bandwidth_hz)
