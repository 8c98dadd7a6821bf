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
