import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device with an explicit CUDA index, so
    devices compare equal to the ones tensors report.  The port's entry
    points default to the card; asking for CUDA where there is none
    raises instead of carrying on on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mo_renderer_tpu_torch targets a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def card(device) -> str | None:
    """``name, power.limit`` of the card ``device`` is on, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (a card below its full power limit runs slower under
    load, so a time is reported with both); None for a CPU device."""
    import subprocess

    device = resolve_device(device)
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", f"--id={device.index}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
