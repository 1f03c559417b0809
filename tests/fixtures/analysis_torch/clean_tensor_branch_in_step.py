"""Clean counterpart: the choice stays on the device; branches read host
values only (a shape, a config field, an identity test)."""
import torch


def netes_step(thetas, rewards, cfg, mask=None):
    if mask is not None and thetas.shape[0] > 1 and cfg.halve:
        thetas = thetas * mask
    return torch.where((rewards > 0)[:, None], thetas * 0.5, thetas)
