"""The per-stream workspace of the kernels that cut one output's work
over several blocks and merge the partials in the same launch: K2
(``quant.int8_matmul``, a split of K), K1 and K3 (``paged_attention.
paged_attend`` and ``paged_attend_int8``) and K4 (``quant.
int8_cache_attend``), the last three a split of the positions.

Each such launch writes its f32 partials to the workspace, and the last
block of an output tile or (row, head) to finish, found by a counter,
merges them and resets the counter to 0. The workspace and the counters
are kept and grown across calls, one pair per (device, stream): the
stream orders the calls, so each launch finds the counters the previous
one reset, and the kernels of all four share them.
"""

import torch

_sm_counts = {}
_workspaces = {}


def sm_count(device):
    """The number of SMs of the CUDA ``device``, read once."""
    sms = _sm_counts.get(device.index)
    if sms is None:
        sms = _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


def split_workspace(device, stream, elements, counters):
    """The split workspace (at least ``elements`` f32) and the zeroed
    counters (at least ``counters`` int32) of ``stream`` on
    ``device``."""
    key = (device.index, stream)
    ws, count = _workspaces.get(key, (None, None))
    if ws is None or ws.numel() < elements:
        ws = torch.empty(max(elements, 1), dtype=torch.float32,
                         device=device)
    if count is None or count.numel() < counters:
        count = torch.zeros(max(counters, 1), dtype=torch.int32,
                            device=device)
    _workspaces[key] = (ws, count)
    return ws, count
