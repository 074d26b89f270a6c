"""Packed mode's device time against its roofline.  A request must read,
once each at the storage dtype, every row of the distinct leaves its
beams scan and every centroid its ranking reads (the root's and those
under the level-1 nodes the beams keep), the float32 queries, and write
each served (distance, id) pair; and it must score each query against the
centroids it ranks and the real rows of its own leaves (a multiply-add a
dimension).  The leaves come from the reference's beam over the same
queries, which the check has held to what was served.  Summed over the
window's requests, over the device time of the window."""
import numpy as np
import torch

from portbench import reference, roofline


def read(run):
    ref = run.reference
    if run.trace is None or ref is None or ref.index.levels != 2 or not run.units:
        return None
    seconds, records = run.trace.device_s()
    if not records:
        return None
    cfg = run.cell.config
    dim, item = int(cfg["dim"]), np.dtype(cfg["storage_dtype"]).itemsize
    index = ref.index
    sizes = np.array([len(m) for m in index.members])
    kids = index.children[0]
    width = max(ref.b, 8)
    moved = flops = 0.0
    for unit in run.units:
        qn = reference.unit(torch.as_tensor(unit.queries, device=ref.data.device), torch.float64)
        d = reference.cos_dist(qn, ref.lead)
        leaves = reference.beam(d, index, ref.b).cpu().numpy()
        kept = torch.sort(d[:, : index.nodes[0]], dim=1, stable=True).indices[:, :width].cpu().numpy()
        centroids = index.nodes[0] + sum(len(kids[j]) for j in np.unique(kept))
        served = sum(int((p[0] >= 0).sum()) for p in unit.pages)
        moved += roofline.packed_batch_bytes(int(sizes[np.unique(leaves[leaves >= 0])].sum()), centroids,
                                             len(unit.queries), dim, item, served)
        flops += 2.0 * dim * (sizes[leaves[leaves >= 0]].sum() + len(unit.queries) * centroids)
    return roofline.share(moved, flops, seconds)
