"""Self-contained glTF 2.0 / GLB parser producing numpy arrays.

The TPU-native replacement for the reference's `gltf` crate import path
(mo_ecs/src/model/mod.rs:21-94): parses the JSON + binary chunks directly,
resolves accessors into numpy arrays, and decodes embedded images via PIL.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}

_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


class GltfDocument:
    """Parsed glTF: JSON dict + resolved binary buffers."""

    def __init__(self, gltf_json: dict, buffers: list[bytes], base_dir: str):
        self.json = gltf_json
        self.buffers = buffers
        self.base_dir = base_dir

    # --- loading --------------------------------------------------------
    @staticmethod
    def load(path: str) -> "GltfDocument":
        base_dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"glTF":
            return GltfDocument._parse_glb(data, base_dir)
        gltf_json = json.loads(data.decode("utf-8"))
        doc = GltfDocument(gltf_json, [], base_dir)
        doc.buffers = [doc._resolve_buffer(b) for b in gltf_json.get("buffers", [])]
        return doc

    @staticmethod
    def _parse_glb(data: bytes, base_dir: str) -> "GltfDocument":
        magic, version, _length = struct.unpack_from("<III", data, 0)
        if version != 2:
            raise ValueError(f"unsupported GLB version {version}")
        offset = 12
        gltf_json = None
        bin_chunk = b""
        while offset < len(data):
            chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
            offset += 8
            chunk = data[offset : offset + chunk_len]
            offset += chunk_len
            if chunk_type == 0x4E4F534A:  # 'JSON'
                gltf_json = json.loads(chunk.decode("utf-8"))
            elif chunk_type == 0x004E4942:  # 'BIN\0'
                bin_chunk = chunk
        if gltf_json is None:
            raise ValueError("GLB missing JSON chunk")
        doc = GltfDocument(gltf_json, [], base_dir)
        bufs = []
        for b in gltf_json.get("buffers", []):
            if "uri" not in b:
                bufs.append(bin_chunk)
            else:
                bufs.append(doc._resolve_buffer(b))
        doc.buffers = bufs
        return doc

    def _resolve_buffer(self, buf: dict) -> bytes:
        uri = buf["uri"]
        if uri.startswith("data:"):
            b64 = uri.split(",", 1)[1]
            return base64.b64decode(b64)
        with open(os.path.join(self.base_dir, uri), "rb") as f:
            return f.read()

    # --- accessors ------------------------------------------------------
    def buffer_view_bytes(self, view_idx: int) -> bytes:
        view = self.json["bufferViews"][view_idx]
        buf = self.buffers[view["buffer"]]
        off = view.get("byteOffset", 0)
        return buf[off : off + view["byteLength"]]

    def accessor(self, idx: int) -> np.ndarray:
        """Resolve accessor -> (count, components) array (1D for SCALAR)."""
        acc = self.json["accessors"][idx]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        itemsize = np.dtype(dtype).itemsize

        if "bufferView" in acc:
            view = self.json["bufferViews"][acc["bufferView"]]
            buf = self.buffers[view["buffer"]]
            start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = view.get("byteStride", 0) or (itemsize * ncomp)
            if stride == itemsize * ncomp:
                arr = np.frombuffer(
                    buf, dtype=dtype, count=count * ncomp, offset=start
                ).reshape(count, ncomp)
            else:
                raw = np.frombuffer(
                    buf, dtype=np.uint8, count=stride * count, offset=start
                ).reshape(count, stride)
                arr = raw[:, : itemsize * ncomp].copy().view(dtype).reshape(count, ncomp)
            arr = np.array(arr)  # own the memory
        else:
            arr = np.zeros((count, ncomp), dtype=dtype)

        # sparse substitution
        sparse = acc.get("sparse")
        if sparse:
            sc = sparse["count"]
            ind = sparse["indices"]
            idx_dtype = _COMPONENT_DTYPES[ind["componentType"]]
            iview = self.json["bufferViews"][ind["bufferView"]]
            ibuf = self.buffers[iview["buffer"]]
            istart = iview.get("byteOffset", 0) + ind.get("byteOffset", 0)
            indices = np.frombuffer(ibuf, dtype=idx_dtype, count=sc, offset=istart)
            val = sparse["values"]
            vview = self.json["bufferViews"][val["bufferView"]]
            vbuf = self.buffers[vview["buffer"]]
            vstart = vview.get("byteOffset", 0) + val.get("byteOffset", 0)
            values = np.frombuffer(
                vbuf, dtype=dtype, count=sc * ncomp, offset=vstart
            ).reshape(sc, ncomp)
            arr[indices] = values

        if ncomp == 1:
            arr = arr.reshape(count)
        return arr

    def accessor_f32(self, idx: int) -> np.ndarray:
        """Accessor converted to float32 with glTF normalization rules."""
        acc = self.json["accessors"][idx]
        arr = self.accessor(idx)
        if arr.dtype == np.float32:
            return arr
        if acc.get("normalized", False):
            info = np.iinfo(arr.dtype)
            if info.min < 0:
                return np.maximum(arr.astype(np.float32) / info.max, -1.0)
            return arr.astype(np.float32) / info.max
        return arr.astype(np.float32)

    # --- images ---------------------------------------------------------
    def image_rgba8(self, image_idx: int) -> np.ndarray:
        """Decode image `image_idx` to (H, W, 4) uint8 (mod.rs:35-78)."""
        from . import image_io

        img = self.json["images"][image_idx]
        if "bufferView" in img:
            raw = self.buffer_view_bytes(img["bufferView"])
            return image_io.load_ldr(raw)
        uri = img["uri"]
        if uri.startswith("data:"):
            return image_io.load_ldr(base64.b64decode(uri.split(",", 1)[1]))
        return image_io.load_ldr(os.path.join(self.base_dir, uri))

    # --- scene walking ----------------------------------------------------
    def node_matrix(self, node: dict) -> np.ndarray:
        """Local transform of a node as m[row, col] float32."""
        if "matrix" in node:
            # glTF stores column-major
            return np.array(node["matrix"], dtype=np.float32).reshape(4, 4).T
        from ..math import quat as quat_math
        from ..math.projections import from_scale_rotation_translation

        t = np.array(node.get("translation", [0, 0, 0]), dtype=np.float32)
        r = np.array(node.get("rotation", [0, 0, 0, 1]), dtype=np.float32)
        s = np.array(node.get("scale", [1, 1, 1]), dtype=np.float32)
        return from_scale_rotation_translation(s, quat_math.to_mat3(r), t)

    def texture_image_index(self, texture_idx) -> int | None:
        """texture index -> image (source) index (mod.rs:162-203)."""
        if texture_idx is None:
            return None
        tex = self.json["textures"][texture_idx]
        return tex.get("source")
