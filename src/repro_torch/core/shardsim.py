"""Lane-axis device parallelism for the DES: the lanes split over devices.

Port of ``repro/core/shardsim.py``.  ``memsim``'s flattened
``(cells x reps)`` batch is embarrassingly parallel -- lanes are
independent Markov chains that never exchange data -- so the lanes are
split into ``ndev`` equal contiguous slices, one a device.  Stage A (the
draws and every transcendental law) runs once at the UNPADDED width on
the caller's device; in each chunk, stage B (the scans, K4
``memsim_ts_scan`` / K5 ``memsim_event_scan``) is one launch a shard, on
its device, over its slice.  Each shard keeps its own carry and its own
rows of the histogram for the whole run.

Determinism contract (the reference's, held by
``tests/test_torch_shardsim.py``):

  * every random stream is keyed by the **logical lane index**
    (``fold_in(chunk_key, lane)``), never by batch width or device count;
  * chunk lengths and budgets derive from the UNPADDED flat width, so
    padding (a device-count artifact) cannot perturb them;
  * the batch is padded to a multiple of the device count with NaN lanes
    (NaN terms, the reference's pad values for the draws): a NaN channel
    never records an arrival, so a padding lane's row of the histogram
    stays out of every lane's, and the host drops it;
  * histograms are indexed by *global* lane: each shard's rows are its
    lanes' rows, and the host merges the shards by putting their int32
    rows back in lane order (the reference's integer ``bincount`` over
    global ``lane * N_BINS + bin`` slots, which the per-lane rows of the
    port's scans already are).  Counts are integers, exact in any order.

Together these make a sharded run **bit-identical** to one device, so
``devices`` may default to an environment knob (``REPRO_DES_DEVICES``)
without moving a single histogram.

How many devices there are: on CUDA, ``torch.cuda.device_count()``; a
run asks for at most that many and never wraps shards round onto fewer
cards.  On the CPU, ``$REPRO_DES_HOST_DEVICES`` (default 1) makes the
process count as that many logical host devices, whose shards run one
after another: the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=N``, so that the CPU
tests cover device counts and widths that do not divide.  It is never
read for CUDA.
"""

from __future__ import annotations

import os

import torch

#: Environment knob consulted when ``devices=None``: an integer device
#: count, or ``auto`` for every local device.  Unset means 1 (the exact
#: single-device path).
ENV_DEVICES = "REPRO_DES_DEVICES"

#: Logical host devices of a CPU run (see the module note).
ENV_HOST_DEVICES = "REPRO_DES_HOST_DEVICES"


def local_devices(device="cuda") -> list:
    """The devices a run on ``device``'s type may shard over."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    env = os.environ.get(ENV_HOST_DEVICES, "").strip()
    try:
        n = int(env) if env else 1
    except ValueError:
        raise ValueError(f"${ENV_HOST_DEVICES} must be an int; got "
                         f"{env!r}") from None
    if n < 1:
        raise ValueError(f"${ENV_HOST_DEVICES} must be >= 1; got {n}")
    return [torch.device("cpu")] * n


def resolve_devices(devices=None, device="cuda") -> int:
    """Resolve a ``devices=`` knob to a concrete device count.

    ``None`` consults ``$REPRO_DES_DEVICES`` (unset -> 1); ``"auto"``
    means every local device of ``device``'s type; an int (or int-like
    string) is validated against that count.  Results never depend on the
    choice -- only wall-clock does."""
    if devices is None:
        env = os.environ.get(ENV_DEVICES, "").strip()
        if not env:
            return 1
        devices = env
    if isinstance(devices, str):
        if devices.lower() == "auto":
            return max(len(local_devices(device)), 1)
        try:
            devices = int(devices)
        except ValueError:
            raise ValueError(
                f"devices must be an int, 'auto' or None; got {devices!r} "
                f"(via ${ENV_DEVICES}?)") from None
    n = int(devices)
    if n < 1:
        raise ValueError(f"devices must be >= 1, got {n}")
    if n == 1:
        return 1
    avail = len(local_devices(device))
    if n > avail:
        hint = (f"the {avail} CUDA card(s)"
                if torch.device(device).type == "cuda" else
                f"the {avail} logical host device(s); set "
                f"{ENV_HOST_DEVICES}={n} to count the CPU as {n}")
        raise ValueError(f"devices={n} exceeds {hint}")
    return n


def pad_width(n: int, ndev: int) -> int:
    """Lanes to append so ``n`` divides evenly over ``ndev`` devices."""
    return (-int(n)) % int(ndev)


def shards(n_total: int, ndev: int, device="cuda") -> list:
    """(lane slice, device) of each shard of a padded ``n_total``-lane
    batch: equal contiguous slices, shard i on the i-th local device."""
    width = n_total // ndev
    devs = local_devices(device)[:ndev] if ndev > 1 else [
        torch.device(device)]
    return [(slice(i * width, (i + 1) * width), devs[i])
            for i in range(ndev)]


def pad_lanes(x, pad: int, value):
    """Append ``pad`` constant lanes to the trailing axis."""
    if pad == 0:
        return x
    fill = torch.full(x.shape[:-1] + (pad,), value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill], dim=-1)
