"""fetch_ms: device ms per frame of the device-to-host copies (the
fetch of Renderer.render, passes/present.py unpack_rgba8), from the
traced frames."""


def read(run):
    rec = run.get("trace")
    if not rec or not rec.get("units"):
        return None
    us = sum(e - s for name, s, e in rec["device_ops"]
             if name.startswith("Memcpy DtoH"))
    return us / 1e3 / rec["units"] if us > 0 else None
