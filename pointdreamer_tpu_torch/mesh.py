"""Textured mesh container with OBJ / PLY / GLB files (twin of
core/mesh.py; reference utils/mesh.py, the kiui-derived Mesh class,
:10-845, used by the commented-out glb export at demo.py:467-472).

A numpy dataclass and a self-contained binary glTF 2.0 writer and reader:
one primitive, uint32 indices, float32 positions and uvs (vertices
unwelded per (position, uv) pair, v flipped to glTF's top-left origin),
the texture as an embedded PNG from `io.encode_png`.
"""
from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import io as pio

_GLB_MAGIC, _JSON, _BIN = 0x46546C67, 0x4E4F534A, 0x004E4942
_COMPONENTS = {5125: np.uint32, 5126: np.float32}
_WIDTH = {"SCALAR": 1, "VEC2": 2, "VEC3": 3}


@dataclass
class Mesh:
    vertices: np.ndarray                    # [V,3] float32
    faces: np.ndarray                       # [F,3] int
    uvs: Optional[np.ndarray] = None        # [Nuv,2], v up
    face_uv_idx: Optional[np.ndarray] = None
    texture: Optional[np.ndarray] = None    # [H,W,3] float in [0,1]

    @classmethod
    def load(cls, path: str) -> "Mesh":
        """An OBJ (with the PNG beside it), a PLY mesh, or a GLB as
        `write_glb` writes it."""
        if path.endswith(".glb"):
            return cls.load_glb(path)
        if path.endswith(".ply"):
            m = pio.load_ply_mesh(path)
            return cls(vertices=m["vertices"], faces=m["faces"])
        m = pio.load_obj(path)
        png = path.replace(".obj", ".png")
        tex = pio.load_rgb(png) if os.path.exists(png) else None
        return cls(vertices=m["vertices"], faces=m["faces"],
                   uvs=m.get("uvs"), face_uv_idx=m.get("face_uv_idx"),
                   texture=tex)

    def write(self, path: str) -> None:
        if path.endswith(".obj"):
            pio.save_textured_obj(self.vertices, self.uvs, self.faces,
                                  self.face_uv_idx, path)
            if self.texture is not None:
                pio.save_rgb(self.texture, path.replace(".obj", ".png"))
        elif path.endswith(".glb"):
            self.write_glb(path)
        elif path.endswith(".ply"):
            pio.save_colored_pc_ply(
                self.vertices, np.full_like(self.vertices, 0.7), path)
        else:
            raise ValueError(f"unknown mesh format: {path}")

    # ------------------------------------------------------------------
    def _unweld_for_gltf(self):
        """glTF has one index buffer: one vertex per (position, uv)."""
        if self.uvs is None:
            return (self.vertices.astype(np.float32), None,
                    self.faces.astype(np.uint32))
        n = len(self.uvs) + 1
        key = self.faces.astype(np.int64) * n \
            + self.face_uv_idx.astype(np.int64)
        uniq, inv = np.unique(key.reshape(-1), return_inverse=True)
        pos = self.vertices[uniq // n].astype(np.float32)
        uv = self.uvs[uniq % n].astype(np.float32).copy()
        uv[:, 1] = 1.0 - uv[:, 1]          # glTF's uv origin is top-left
        return pos, uv, inv.reshape(-1, 3).astype(np.uint32)

    def write_glb(self, path: str) -> None:
        pos, uv, idx = self._unweld_for_gltf()
        buffers = []

        def add(data: bytes):
            offset = sum(len(b) for b in buffers)
            buffers.append(data + b"\x00" * ((-len(data)) % 4))
            return offset, len(data)

        idx_off, idx_len = add(idx.tobytes())
        pos_off, pos_len = add(pos.tobytes())
        views = [
            {"buffer": 0, "byteOffset": idx_off, "byteLength": idx_len,
             "target": 34963},
            {"buffer": 0, "byteOffset": pos_off, "byteLength": pos_len,
             "target": 34962},
        ]
        accessors = [
            {"bufferView": 0, "componentType": 5125, "count": idx.size,
             "type": "SCALAR"},
            {"bufferView": 1, "componentType": 5126, "count": len(pos),
             "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
        ]
        attributes = {"POSITION": 1}
        material = {"pbrMetallicRoughness": {
            "metallicFactor": 0.0, "roughnessFactor": 1.0}}
        images, textures, samplers = [], [], []
        if uv is not None:
            uv_off, uv_len = add(uv.tobytes())
            views.append({"buffer": 0, "byteOffset": uv_off,
                          "byteLength": uv_len, "target": 34962})
            accessors.append({"bufferView": len(views) - 1,
                              "componentType": 5126, "count": len(uv),
                              "type": "VEC2"})
            attributes["TEXCOORD_0"] = len(accessors) - 1
        if self.texture is not None and uv is not None:
            # truncated to 8 bits, as the JAX package's PIL export
            arr = (np.clip(self.texture, 0, 1) * 255).astype(np.uint8)
            img_off, img_len = add(pio.encode_png(arr))
            views.append({"buffer": 0, "byteOffset": img_off,
                          "byteLength": img_len})
            images.append({"bufferView": len(views) - 1,
                           "mimeType": "image/png"})
            samplers.append({"magFilter": 9729, "minFilter": 9729,
                             "wrapS": 10497, "wrapT": 10497})
            textures.append({"sampler": 0, "source": 0})
            material["pbrMetallicRoughness"]["baseColorTexture"] = {
                "index": 0}
        gltf = {
            "asset": {"version": "2.0", "generator": "pointdreamer_tpu"},
            "scene": 0,
            "scenes": [{"nodes": [0]}],
            "nodes": [{"mesh": 0}],
            "meshes": [{"primitives": [{
                "attributes": attributes, "indices": 0, "material": 0}]}],
            "materials": [material],
            "bufferViews": views,
            "accessors": accessors,
            "buffers": [{"byteLength": sum(len(b) for b in buffers)}],
        }
        if images:
            gltf.update(images=images, textures=textures, samplers=samplers)
        js = json.dumps(gltf).encode()
        js += b" " * ((-len(js)) % 4)
        bin_chunk = b"".join(buffers)
        total = 12 + 8 + len(js) + 8 + len(bin_chunk)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", _GLB_MAGIC, 2, total))
            f.write(struct.pack("<II", len(js), _JSON))
            f.write(js)
            f.write(struct.pack("<II", len(bin_chunk), _BIN))
            f.write(bin_chunk)

    @classmethod
    def load_glb(cls, path: str) -> "Mesh":
        """A GLB of one primitive as `write_glb` writes it (the unwelded
        vertices; uvs back to v up; the PNG texture decoded)."""
        gltf, binary = read_glb(path)

        def accessor(i):
            a = gltf["accessors"][i]
            view = gltf["bufferViews"][a["bufferView"]]
            arr = np.frombuffer(binary, _COMPONENTS[a["componentType"]],
                                a["count"] * _WIDTH[a["type"]],
                                view.get("byteOffset", 0))
            return arr.reshape(a["count"], -1) if _WIDTH[a["type"]] > 1 \
                else arr

        prim = gltf["meshes"][0]["primitives"][0]
        faces = accessor(prim["indices"]).astype(np.int64).reshape(-1, 3)
        mesh = cls(vertices=accessor(prim["attributes"]["POSITION"]).copy(),
                   faces=faces)
        if "TEXCOORD_0" in prim["attributes"]:
            uv = accessor(prim["attributes"]["TEXCOORD_0"]).copy()
            uv[:, 1] = 1.0 - uv[:, 1]
            mesh.uvs, mesh.face_uv_idx = uv, faces.copy()
        if gltf.get("images"):
            view = gltf["bufferViews"][gltf["images"][0]["bufferView"]]
            o = view.get("byteOffset", 0)
            png = pio.decode_png(binary[o:o + view["byteLength"]])
            mesh.texture = png[..., :3].astype(np.float32) / 255.0
        return mesh


def read_glb(path: str) -> Tuple[dict, bytes]:
    """A binary glTF's (JSON chunk as a dict, BIN chunk bytes)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version, total = struct.unpack_from("<III", data, 0)
    if magic != _GLB_MAGIC or version != 2 or total != len(data):
        raise ValueError(f"{path}: not a glTF 2.0 binary")
    n, kind = struct.unpack_from("<II", data, 12)
    if kind != _JSON:
        raise ValueError(f"{path}: the first chunk is not JSON")
    gltf = json.loads(data[20:20 + n])
    o = 20 + n
    binary = b""
    if o < len(data):
        m, kind = struct.unpack_from("<II", data, o)
        if kind != _BIN:
            raise ValueError(f"{path}: the second chunk is not BIN")
        binary = data[o + 8:o + 8 + m]
    return gltf, binary
