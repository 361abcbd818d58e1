"""In-process scene-construction API (the hydra_api/HydraAPI-2.0 analog).

The reference sketches an in-process API in hydra_api/: storage/scene
handles, mesh-from-data, material/light/camera creation, ``hr2Commit`` and
``hr2CommitAndRender``, plus an ``IRenderDriver{LoadScene, CommitDeviceData,
Render}`` contract (hydra_api/hydra_api.h:10-152, hydra_cpu.h:13-68).  This
module provides the same workflow for this renderer: build a scene
programmatically — meshes from numpy arrays, materials, lights, camera,
instances — and commit it into the renderer without authoring XML by hand.

Commit serializes the in-memory description to the standard Hydra scene
library layout (statex XML + .vsgf geometry chunks, what the reference's
HydraAPI writes to its scene library) and runs it through the exact same
``scene.build.load_scene`` path as offline rendering, so the API and the
CLI are guaranteed to agree.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from xml.sax.saxutils import escape

import numpy as np


# ---------------------------------------------------------------------------
# handles


@dataclasses.dataclass
class MeshData:
    """hr2_mesh_from_data (hydra_api.h mesh-from-data entry)."""
    pos: np.ndarray          # [V, 3] or [V, 4]
    norm: np.ndarray         # [V, 3/4] or None
    texc: np.ndarray         # [V, 2] or None
    indices: np.ndarray      # [3T]
    mat_indices: np.ndarray  # [T]
    light_id: int = -1


@dataclasses.dataclass
class MaterialDesc:
    name: str = 'mat'
    diffuse_color: tuple = (0.5, 0.5, 0.5)
    diffuse_tex_id: int = -1
    diffuse_tex_matrix: tuple = None   # 8 floats (sampler row0, row1)
    emission_color: tuple = None   # not None => emissive (light material)
    reflectivity: tuple = None     # mirror-ish specular color
    glossiness: float = 1.0
    light_id: int = -1


@dataclasses.dataclass
class AreaLightDesc:
    name: str = 'light'
    color: tuple = (1.0, 1.0, 1.0)
    multiplier: float = 1.0
    half_width: float = 1.0
    half_length: float = 1.0
    matrix: np.ndarray = None      # placement


@dataclasses.dataclass
class SimpleLightDesc:
    """Non-area light (hydra_api.h light objects beyond the area rect):
    kind 'point' (omni), 'spot' (point + cone falloff) or 'sphere'."""
    kind: str = 'point'
    name: str = 'light'
    color: tuple = (1.0, 1.0, 1.0)
    multiplier: float = 1.0
    radius: float = 1.0            # sphere only
    falloff_angle: float = 60.0    # spot outer cone (deg)
    falloff_angle2: float = 30.0   # spot inner cone (deg)
    matrix: np.ndarray = None      # placement


@dataclasses.dataclass
class TextureDesc:
    """In-memory texture (hrTexture2DCreateFromMemory analog).

    data: [H, W, 4] uint8 (LDR, written as .image4ub, sRGB like file
    textures) or float32 (HDR, written as .image4f — required for an
    importance-sampled env map, scene/build.py sky branch)."""
    name: str = 'tex'
    data: np.ndarray = None


@dataclasses.dataclass
class EnvLightDesc:
    """Sky/environment light (light type="sky"); tex_id = lat-long map."""
    color: tuple = (1.0, 1.0, 1.0)
    multiplier: float = 1.0
    tex_id: int = -1
    tex_matrix: tuple = None       # 8 floats (sampler row0, row1)


@dataclasses.dataclass
class CameraDesc:
    fov: float = 45.0
    pos: tuple = (0.0, 0.0, 15.0)
    look_at: tuple = (0.0, 0.0, 0.0)
    up: tuple = (0.0, 1.0, 0.0)
    near: float = 0.01
    far: float = 100.0


class HRSceneInst:
    """The scene/command-buffer handle (hydra_api hrSceneInst analog):
    accumulates meshes, materials, lights, instances; `commit()` produces
    the device scene."""

    def __init__(self):
        self.meshes: list[MeshData] = []
        self.materials: list[MaterialDesc] = []
        self.lights: list[AreaLightDesc] = []
        self.textures: list[TextureDesc] = []
        self.env: EnvLightDesc = None
        self.simple_lights: list[SimpleLightDesc] = []
        self.remap_lists: list[list[int]] = []
        # (mesh_id, matrix, rmap_id)
        self.instances: list[tuple[int, np.ndarray, int]] = []
        self.camera = CameraDesc()
        self.width = 256
        self.height = 256
        self.trace_depth = 6
        self.spp = 16
        self._committed = None

    # -- creation ------------------------------------------------------
    def mesh_from_data(self, pos, indices, mat_indices=None, norm=None,
                       texc=None) -> int:
        pos = np.asarray(pos, np.float32)
        indices = np.asarray(indices, np.uint32).reshape(-1)
        n_tris = len(indices) // 3
        if mat_indices is None:
            mat_indices = np.zeros(n_tris, np.uint32)
        self.meshes.append(MeshData(
            pos=pos, norm=norm, texc=texc, indices=indices,
            mat_indices=np.asarray(mat_indices, np.uint32)))
        return len(self.meshes) - 1

    def material_create(self, **kw) -> int:
        self.materials.append(MaterialDesc(**kw))
        return len(self.materials) - 1

    def light_area(self, **kw) -> int:
        self.lights.append(AreaLightDesc(**kw))
        return len(self.lights) - 1

    def texture_create(self, data, name: str = 'tex') -> int:
        """Texture from a numpy [H, W, 3|4] array (uint8 LDR / float32 HDR);
        returns the texture id usable in material diffuse_tex_id /
        light_env tex_id (hrTexture2DCreateFromMemory analog)."""
        data = np.asarray(data)
        if data.ndim != 3 or data.shape[2] not in (3, 4):
            raise ValueError('texture data must be [H, W, 3|4]')
        if data.shape[2] == 3:
            alpha = (np.full(data.shape[:2] + (1,), 255, np.uint8)
                     if data.dtype == np.uint8
                     else np.ones(data.shape[:2] + (1,), np.float32))
            data = np.concatenate([data, alpha], axis=2)
        if data.dtype != np.uint8:
            data = data.astype(np.float32)
        self.textures.append(TextureDesc(name=name, data=data))
        return len(self.textures) - 1

    def light_env(self, **kw):
        """Environment (sky) light; tex_id selects a float32 lat-long map
        for importance sampling (light type="sky", clight.h env path)."""
        self.env = EnvLightDesc(**kw)

    def light_point(self, **kw) -> int:
        self.simple_lights.append(SimpleLightDesc(kind='point', **kw))
        return self._simple_light_id()

    def light_spot(self, **kw) -> int:
        self.simple_lights.append(SimpleLightDesc(kind='spot', **kw))
        return self._simple_light_id()

    def light_sphere(self, **kw) -> int:
        self.simple_lights.append(SimpleLightDesc(kind='sphere', **kw))
        return self._simple_light_id()

    def _simple_light_id(self) -> int:
        # simple lights are numbered after the area lights in lights_lib
        return len(self.lights) + len(self.simple_lights) - 1

    def remap_list_create(self, pairs) -> int:
        """Material remap list [(from, to), ...] usable as instance_add's
        rmap_id (RemapMaterialId, integrator_pt_mat.cpp:530-573)."""
        flat = []
        for a, b in pairs:
            flat += [int(a), int(b)]
        self.remap_lists.append(flat)
        return len(self.remap_lists) - 1

    def instance_add(self, mesh_id: int, matrix=None, rmap_id: int = -1) -> int:
        m = np.eye(4, dtype=np.float32) if matrix is None \
            else np.asarray(matrix, np.float32)
        self.instances.append((mesh_id, m, rmap_id))
        return len(self.instances) - 1

    def camera_set(self, **kw):
        self.camera = CameraDesc(**kw)

    def settings_set(self, width=None, height=None, depth=None, spp=None):
        self.width = width or self.width
        self.height = height or self.height
        self.trace_depth = depth or self.trace_depth
        self.spp = spp or self.spp

    # -- commit (hr2Commit) --------------------------------------------
    def commit(self, out_dir: str = None, accel: str = 'auto'):
        """Serialize to a Hydra scene library and load it through the
        standard scene builder.  Returns (scene, meta)."""
        from .scene import build as SB
        out_dir = out_dir or tempfile.mkdtemp(prefix='hr2_scene_')
        xml_path = self._write_library(out_dir)
        scene, meta = SB.load_scene(xml_path, out_dir, accel=accel,
                                    width=self.width, height=self.height)
        self._committed = (scene, meta)
        return scene, meta

    def commit_and_render(self, spp: int = None, integrator: str = 'mispt',
                          out_dir: str = None):
        """hr2CommitAndRender: commit + full render; returns [H,W,4]."""
        from . import render as R
        scene, meta = self.commit(out_dir)
        return R.render(scene, meta, spp=spp or self.spp,
                        integrator=integrator)

    # -- serialization ---------------------------------------------------
    def _write_library(self, out_dir: str) -> str:
        os.makedirs(os.path.join(out_dir, 'data'), exist_ok=True)

        # auto-generate emissive light geometry: every area light gets a
        # rect mesh + emissive material + instance, exactly what the
        # reference HydraAPI emits ("my_area_light_lightmesh",
        # statex *.xml light_id/linst_id linkage)
        materials = list(self.materials)
        meshes = list(self.meshes)
        light_instances = []  # (mesh_id, matrix, light_id)
        for i, L in enumerate(self.lights):
            emis = tuple(c * L.multiplier for c in L.color)
            mat_id = len(materials)
            materials.append(MaterialDesc(
                name=f'{L.name}_material', emission_color=emis, light_id=i))
            hw, hl = L.half_width, L.half_length
            pos = np.array([[-hw, 0, -hl], [hw, 0, -hl],
                            [hw, 0, hl], [-hw, 0, hl]], np.float32)
            norm = np.tile(np.array([[0, -1, 0]], np.float32), (4, 1))
            mesh_id = len(meshes)
            meshes.append(MeshData(
                pos=pos, norm=norm, texc=None,
                indices=np.array([0, 1, 2, 0, 2, 3], np.uint32),
                mat_indices=np.array([mat_id, mat_id], np.uint32),
                light_id=i))
            m = (np.eye(4, dtype=np.float32) if L.matrix is None
                 else np.asarray(L.matrix, np.float32))
            light_instances.append((mesh_id, m, i))

        mesh_locs = []
        for i, m in enumerate(meshes):
            loc = f'data/chunk_{i:05d}.vsgf'
            write_vsgf(os.path.join(out_dir, loc), m)
            mesh_locs.append(loc)

        parts = ['<?xml version="1.0"?>']
        parts.append('<textures_lib>')
        for i, T in enumerate(self.textures):
            h, w = T.data.shape[:2]
            if T.data.dtype == np.uint8:
                loc = f'data/tex_{i:05d}.image4ub'
                payload = T.data.tobytes()
            else:
                loc = f'data/tex_{i:05d}.image4f'
                payload = T.data.astype('<f4').tobytes()
            with open(os.path.join(out_dir, loc), 'wb') as f:
                f.write(np.array([w, h], '<i4').tobytes())
                f.write(payload)
            parts.append(
                f'  <texture id="{i}" name="{escape(T.name)}" loc="{loc}" '
                f'offset="8" bytesize="{len(payload)}" width="{w}" '
                f'height="{h}" channels="4" dl="0" />')
        parts.append('</textures_lib>')

        def _tex_node(tex_id, tex_matrix):
            mat_attr = ''
            if tex_matrix is not None:
                mat_attr = (' matrix="'
                            + ' '.join(str(v) for v in tex_matrix) + '"')
            return (f'<texture id="{tex_id}" type="texref"'
                    f'{mat_attr} addressing_mode_u="wrap" '
                    'addressing_mode_v="wrap" filter="linear" />')

        parts.append('<materials_lib>')
        for i, mat in enumerate(materials):
            lid = f' light_id="{mat.light_id}"' if mat.light_id >= 0 else ''
            parts.append(f'  <material id="{i}" name="{escape(mat.name)}" '
                         f'type="hydra_material"{lid}>')
            if mat.emission_color is not None:
                c = ' '.join(str(v) for v in mat.emission_color)
                parts.append(f'    <emission><color val="{c}" /></emission>')
            else:
                c = ' '.join(str(v) for v in mat.diffuse_color)
                tex = (_tex_node(mat.diffuse_tex_id, mat.diffuse_tex_matrix)
                       if mat.diffuse_tex_id >= 0 else '')
                parts.append('    <diffuse brdf_type="lambert">'
                             f'<color val="{c}">{tex}</color></diffuse>')
                if mat.reflectivity is not None:
                    r = ' '.join(str(v) for v in mat.reflectivity)
                    parts.append(
                        '    <reflectivity brdf_type="phong">'
                        f'<color val="{r}" />'
                        f'<glossiness val="{mat.glossiness}" />'
                        '</reflectivity>')
            parts.append('  </material>')
        parts.append('</materials_lib>')

        parts.append('<geometry_lib>')
        for i, (m, loc) in enumerate(zip(meshes, mesh_locs)):
            lid = f' light_id="{m.light_id}"' if m.light_id >= 0 else ''
            parts.append(f'  <mesh id="{i}" name="mesh{i}" type="vsgf" '
                         f'loc="{loc}"{lid} />')
        parts.append('</geometry_lib>')

        parts.append('<lights_lib>')
        for i, L in enumerate(self.lights):
            c = ' '.join(str(v) for v in L.color)
            parts.append(
                f'  <light id="{i}" name="{escape(L.name)}" type="area" '
                'shape="rect" distribution="diffuse" visible="1">\n'
                f'    <size half_length="{L.half_length}" '
                f'half_width="{L.half_width}" />\n'
                f'    <intensity><color val="{c}" />'
                f'<multiplier val="{L.multiplier}" /></intensity>\n'
                '  </light>')
        for j, SL in enumerate(self.simple_lights):
            lid = len(self.lights) + j
            c = ' '.join(str(v) for v in SL.color)
            if SL.kind == 'sphere':
                parts.append(
                    f'  <light id="{lid}" name="{escape(SL.name)}" '
                    'type="area" shape="sphere" distribution="uniform" '
                    'visible="0">\n'
                    f'    <size radius="{SL.radius}" />\n'
                    f'    <intensity><color val="{c}" />'
                    f'<multiplier val="{SL.multiplier}" /></intensity>\n'
                    '  </light>')
            else:
                dist = 'spot' if SL.kind == 'spot' else 'uniform'
                extra = ''
                if SL.kind == 'spot':
                    extra = (f'    <falloff_angle val="{SL.falloff_angle}" '
                             '/>\n'
                             '    <falloff_angle2 '
                             f'val="{SL.falloff_angle2}" />\n')
                parts.append(
                    f'  <light id="{lid}" name="{escape(SL.name)}" '
                    f'type="point" shape="point" distribution="{dist}" '
                    'visible="0">\n' + extra +
                    f'    <intensity><color val="{c}" />'
                    f'<multiplier val="{SL.multiplier}" /></intensity>\n'
                    '  </light>')
        if self.env is not None:
            E = self.env
            c = ' '.join(str(v) for v in E.color)
            tex = (_tex_node(E.tex_id, E.tex_matrix)
                   if E.tex_id >= 0 else '')
            parts.append(
                f'  <light id="{len(self.lights) + len(self.simple_lights)}"'
                ' name="env" type="sky" '
                'shape="point" distribution="uniform" visible="1">\n'
                f'    <intensity><color val="{c}">{tex}</color>'
                f'<multiplier val="{E.multiplier}" /></intensity>\n'
                '  </light>')
        parts.append('</lights_lib>')

        cam = self.camera
        parts.append(
            '<cam_lib>\n'
            '  <camera id="0" name="api camera" type="uvn">\n'
            f'    <fov>{cam.fov}</fov>\n'
            f'    <nearClipPlane>{cam.near}</nearClipPlane>\n'
            f'    <farClipPlane>{cam.far}</farClipPlane>\n'
            f'    <up>{" ".join(str(v) for v in cam.up)}</up>\n'
            f'    <position>{" ".join(str(v) for v in cam.pos)}</position>\n'
            f'    <look_at>{" ".join(str(v) for v in cam.look_at)}</look_at>\n'
            '  </camera>\n'
            '</cam_lib>')

        parts.append(
            '<render_lib>\n'
            '  <render_settings type="HydraModern" id="0">\n'
            f'    <width>{self.width}</width>\n'
            f'    <height>{self.height}</height>\n'
            f'    <trace_depth>{self.trace_depth}</trace_depth>\n'
            f'    <maxRaysPerPixel>{self.spp}</maxRaysPerPixel>\n'
            '  </render_settings>\n'
            '</render_lib>')

        parts.append('<scenes>\n  <scene id="0" name="api scene">')
        if self.remap_lists:
            parts.append('    <remap_lists>')
            for rl in self.remap_lists:
                parts.append('      <remap_list val="'
                             + ' '.join(str(v) for v in rl) + '" />')
            parts.append('    </remap_lists>')
        iid = 0
        for mesh_id, mat, rmap_id in self.instances:
            mstr = ' '.join(f'{v:g}' for v in np.asarray(mat).reshape(-1))
            parts.append(f'    <instance id="{iid}" mesh_id="{mesh_id}" '
                         f'rmap_id="{rmap_id}" matrix="{mstr}" />')
            iid += 1
        for i, L in enumerate(self.lights):
            m = (np.eye(4, dtype=np.float32) if L.matrix is None
                 else np.asarray(L.matrix, np.float32))
            mstr = ' '.join(f'{v:g}' for v in m.reshape(-1))
            parts.append(f'    <instance_light id="{i}" light_id="{i}" '
                         f'matrix="{mstr}" lgroup_id="-1" />')
        for j, SL in enumerate(self.simple_lights):
            lid = len(self.lights) + j
            m = (np.eye(4, dtype=np.float32) if SL.matrix is None
                 else np.asarray(SL.matrix, np.float32))
            mstr = ' '.join(f'{v:g}' for v in m.reshape(-1))
            parts.append(f'    <instance_light id="{lid}" light_id="{lid}" '
                         f'matrix="{mstr}" lgroup_id="-1" />')
        if self.env is not None:
            eid = len(self.lights) + len(self.simple_lights)
            eye = ' '.join(f'{v:g}'
                           for v in np.eye(4, dtype=np.float32).reshape(-1))
            parts.append(f'    <instance_light id="{eid}" light_id="{eid}" '
                         f'matrix="{eye}" lgroup_id="-1" />')
        for mesh_id, m, lid in light_instances:
            mstr = ' '.join(f'{v:g}' for v in m.reshape(-1))
            parts.append(f'    <instance id="{iid}" mesh_id="{mesh_id}" '
                         f'rmap_id="-1" matrix="{mstr}" '
                         f'light_id="{lid}" linst_id="{lid}" />')
            iid += 1
        parts.append('  </scene>\n</scenes>')

        xml_path = os.path.join(out_dir, 'statex_00001.xml')
        with open(xml_path, 'w') as f:
            f.write('\n'.join(parts))
        return xml_path


def write_vsgf(path: str, m: MeshData):
    """Writer matching scene/vsgf.py's reader (cmesh4 layout)."""
    pos = np.asarray(m.pos, np.float32)
    if pos.shape[1] == 3:
        pos = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], -1)
    V = len(pos)
    if m.norm is None:
        norm = _face_normals_to_vertices(pos[:, :3], m.indices)
    else:
        norm = np.asarray(m.norm, np.float32)
    if norm.shape[1] == 3:
        norm = np.concatenate([norm, np.zeros((V, 1), np.float32)], -1)
    tang = np.zeros((V, 4), np.float32)
    texc = (np.zeros((V, 2), np.float32) if m.texc is None
            else np.asarray(m.texc, np.float32))
    ind = np.asarray(m.indices, np.uint32).reshape(-1)
    mat = np.asarray(m.mat_indices, np.uint32).reshape(-1)

    blob = b''.join(a.tobytes() for a in (pos, norm, tang, texc, ind, mat))
    header = np.zeros(1, dtype=np.dtype(
        [('size', '<u8'), ('verts', '<u4'), ('inds', '<u4'),
         ('mats', '<u4'), ('flags', '<u4')]))
    header['size'] = 24 + len(blob)
    header['verts'] = V
    header['inds'] = len(ind)
    header['mats'] = int(mat.max()) + 1 if len(mat) else 0
    header['flags'] = 1  # HAS_TANGENT (tangents are written)
    with open(path, 'wb') as f:
        f.write(header.tobytes())
        f.write(blob)


def _face_normals_to_vertices(pos3, indices):
    ind = np.asarray(indices, np.int64).reshape(-1, 3)
    n = np.zeros((len(pos3), 3), np.float32)
    e1 = pos3[ind[:, 1]] - pos3[ind[:, 0]]
    e2 = pos3[ind[:, 2]] - pos3[ind[:, 0]]
    fn = np.cross(e1, e2)
    for k in range(3):
        np.add.at(n, ind[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(ln, 1e-20)
    return np.concatenate([n, np.zeros((len(n), 1), np.float32)], -1)


def hr2_create_scene() -> HRSceneInst:
    """hr2Init / scene-handle creation."""
    return HRSceneInst()
