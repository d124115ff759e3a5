"""Roofline terms from dry-run records, on NVIDIA H100 SXM constants.

Per (arch x shape x mesh) record produced by ``launch.dryrun``:

    compute_s  = FLOPs_per_device        / 989e12   (bf16 dense, tensor cores)
    memory_s   = HBM_bytes_per_device    / 3.35e12  (HBM3)
    nvlink_s   = NVLink coll bytes/device / 450e9   (NVLink 4, per direction
                                                     per GPU, inside a node
                                                     of 8)
    net_s      = network coll bytes/dev  / 50e9     (one 400 Gb/s NDR port
                                                     per GPU across nodes: a
                                                     stated assumption, as
                                                     the reference's DCN
                                                     figure is)

The first three are NVIDIA's H100 SXM data-sheet figures.  The dominant
term is the bottleneck; roofline fraction = compute_s / max(terms).
``model_flops_dev`` uses 6·N·D for training and 2·N·D for inference steps
(N = active params for MoE), and the useful-compute ratio MODEL_FLOPS /
counted FLOPs exposes remat, causal and dispatch waste.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

PEAK_FLOPS = 989e12        # bf16 dense FLOP/s / GPU
PEAK_FLOPS_FP32 = 67e12    # fp32 FLOP/s / GPU, outside the tensor cores
HBM_BW = 3.35e12           # bytes/s / GPU
NVLINK_BW = 450e9          # bytes/s / GPU / direction, inside a node
NET_BW = 50e9              # bytes/s / GPU across nodes (assumed 400 Gb/s)
CHIPS = {"pod1": 256, "pod2": 512}


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    step: str
    compute_s: float
    memory_s: float
    nvlink_s: float
    net_s: float
    model_flops_dev: float
    counted_flops_dev: float
    mem_gib: float
    attn_hbm_bytes: float = 0.0

    @property
    def memory_kernel_s(self) -> float:
        """Memory term on the kernel path.  The reference subtracts the XLA
        path's attention intermediates here; the port's count already
        takes the hand-written kernels' own bytes (scores never reach
        HBM), so this is ``memory_s``."""
        return self.memory_s

    @property
    def kernel_step_time_s(self) -> float:
        return max(self.compute_s, self.memory_kernel_s, self.nvlink_s,
                   self.net_s)

    @property
    def kernel_roofline_frac(self) -> float:
        t = self.kernel_step_time_s
        return self.compute_s / t if t else 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "nvlink": self.nvlink_s, "net": self.net_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.nvlink_s, self.net_s)

    @property
    def roofline_frac(self) -> float:
        return self.compute_s / self.step_time_s if self.step_time_s else 0.0

    @property
    def useful_ratio(self) -> float:
        return (self.model_flops_dev / self.counted_flops_dev
                if self.counted_flops_dev else 0.0)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-predicted step time."""
        if not self.step_time_s:
            return 0.0
        return self.model_flops_dev / (self.step_time_s * PEAK_FLOPS)


def model_flops(step: str, n_active_params: int, tokens: int) -> float:
    """6·N·D for a train step, 2·N·D for an inference step."""
    return (6.0 if step == "train_step" else 2.0) * n_active_params * tokens


def from_record(rec: dict) -> Roofline | None:
    if not rec.get("ok"):
        return None
    c = rec["cost"]
    chips = CHIPS[rec["mesh"]]
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        step=rec["step"],
        compute_s=c["flops"] / PEAK_FLOPS,
        memory_s=c["hbm_bytes"] / HBM_BW,
        nvlink_s=c["coll_nvlink_bytes"] / NVLINK_BW,
        net_s=c["coll_net_bytes"] / NET_BW,
        model_flops_dev=model_flops(rec["step"], rec["n_active_params"],
                                    rec["tokens_per_step"]) / chips,
        counted_flops_dev=c["flops"],
        mem_gib=rec["memory"]["peak_bytes_est"] / 2**30,
        attn_hbm_bytes=rec.get("attn_hbm_bytes", 0.0),
    )


ADVICE = {
    "compute": "compute-bound: reduce counted waste (remat policy, causal "
               "block skipping, MoE dispatch) or accept — this is the "
               "target.",
    "memory": "HBM-bound: raise arithmetic intensity (fuse the elementwise "
              "passes, larger per-GPU tiles, bf16 intermediates, fewer "
              "re-reads).",
    "nvlink": "NVLink-bound: reshard to cut all-gathers (wider FSDP shards, "
              "sequence-parallel boundaries, overlap or batch "
              "collectives).",
    "net": "network-bound: keep cross-node traffic to one gradient reduce "
           "per step (tensor parallelism inside a node of 8); compress "
           "grads or accumulate more microbatches.",
}


def load_dir(path: str) -> list[dict]:
    out = []
    for name in sorted(os.listdir(path)):
        if name.endswith(".json"):
            with open(os.path.join(path, name)) as f:
                out.append(json.load(f))
    return out


def table(records: list[dict], mesh: str = "pod1") -> str:
    rows = ["| arch | shape | step | compute s | memory s | mem(kern) s "
            "| nvlink s | net s | bottleneck | roofline | roofline(kern) "
            "| MFU | useful | mem GiB |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for rec in records:
        if rec.get("mesh") != mesh:
            continue
        if rec.get("skipped"):
            rows.append(f"| {rec['arch']} | {rec['shape']} | — | — | — | — "
                        f"| — | — | SKIP | — | — | — | — | — |")
            continue
        r = from_record(rec)
        if r is None:
            rows.append(f"| {rec['arch']} | {rec['shape']} | FAIL "
                        f"| — | — | — | — | — | — | — | — | — | — | — |")
            continue
        rows.append(
            f"| {r.arch} | {r.shape} | {r.step.replace('_step', '')} "
            f"| {r.compute_s:.4f} | {r.memory_s:.4f} "
            f"| {r.memory_kernel_s:.4f} | {r.nvlink_s:.4f} "
            f"| {r.net_s:.4f} | {r.dominant} | {r.roofline_frac:.2f} "
            f"| {r.kernel_roofline_frac:.2f} "
            f"| {r.mfu:.2f} | {r.useful_ratio:.2f} | {r.mem_gib:.1f} |")
    return "\n".join(rows)


def meshes_table(records: list[dict]) -> str:
    """One row per applicable (arch, shape): each mesh's per-device
    memory, FLOPs, HBM bytes, collective bytes (NVLink + network) and
    dominant term; the cells skipped on every mesh in a last line."""
    cols = [f"{m} {c}" for m in CHIPS for c in
            ("mem GiB", "FLOP", "HBM B", "coll B", "bound")]
    rows = ["| arch | shape | step | " + " | ".join(cols) + " |",
            "|---|---|---|" + "---|" * len(cols)]
    by_cell: dict = {}
    for rec in records:
        by_cell.setdefault((rec["arch"], rec["shape"]), {})[rec["mesh"]] = rec
    skipped = [f"{a} x {sh}" for (a, sh), recs in by_cell.items()
               if all(r.get("skipped") for r in recs.values())]
    for (arch, shape), recs in by_cell.items():
        if f"{arch} x {shape}" in skipped:
            continue
        step, cells = "—", []
        for mesh in CHIPS:
            rec = recs.get(mesh, {})
            r = from_record(rec) if rec else None
            if r is None:
                word = "SKIP" if rec.get("skipped") else "FAIL"
                cells += [word] + ["—"] * 4
                continue
            step = r.step.replace("_step", "")
            c = rec["cost"]
            cells += [f"{r.mem_gib:.2f}", f"{c['flops']:.3e}",
                      f"{c['hbm_bytes']:.3e}",
                      f"{c['coll_nvlink_bytes'] + c['coll_net_bytes']:.3e}",
                      r.dominant]
        rows.append(f"| {arch} | {shape} | {step} | " + " | ".join(cells)
                    + " |")
    if skipped:
        rows.append("\nNot applicable (skipped): " + ", ".join(skipped) + ".")
    return "\n".join(rows)


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="pod1",
                    choices=[*CHIPS, "both"])
    args = ap.parse_args()
    recs = load_dir(args.dir)
    if args.mesh == "both":
        print(meshes_table(recs))
        return
    print(table(recs, args.mesh))
    print()
    for rec in recs:
        r = from_record(rec)
        if r and rec.get("mesh") == args.mesh:
            print(f"{r.arch:22s} {r.shape:12s} -> {r.dominant}: "
                  f"{ADVICE[r.dominant]}")


if __name__ == "__main__":
    main()
