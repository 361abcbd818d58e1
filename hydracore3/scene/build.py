"""Scene build: Hydra XML state -> flat device arrays (the ``Scene`` pytree).

Batched equivalent of the reference's ``LoadScene`` pipeline
(integrator_pt_scene.cpp:945-1076 and the per-library loaders it calls).
Everything ends up in struct-of-arrays form mirroring the reference's flat
device tables (integrator_pt.h:472-591): one row per material/light, one flat
texel pool, packed vertex data, and a world-space triangle soup (plus
per-mesh object-space arrays for the two-level BVH path).

Static facts (counts, feature flags, integrator settings) live in
``SceneMeta`` which is NOT a pytree — it is compile-time data for jit.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import hydra_xml
from . import vsgf
from ..ops import texture as tex

# Material type ids (include/cmaterial.h:38-46)
MAT_TYPE_GLTF = 1
MAT_TYPE_GLASS = 2
MAT_TYPE_CONDUCTOR = 3
MAT_TYPE_DIFFUSE = 4
MAT_TYPE_PLASTIC = 5
MAT_TYPE_BLEND = 6
MAT_TYPE_DIELECTRIC = 7
MAT_TYPE_THIN_FILM = 8
MAT_TYPE_LIGHT_SOURCE = 0xEFFFFFFF

# GLTF component flags (cmaterial.h:26-36)
GLTF_COMPONENT_LAMBERT = 1
GLTF_COMPONENT_COAT = 2
GLTF_COMPONENT_METAL = 4
GLTF_METAL_PERF_MIRROR = 8
GLTF_COMPONENT_ORENNAYAR = 16
FLAG_NMAP_INVERT_X = 32
FLAG_NMAP_INVERT_Y = 64
FLAG_NMAP_SWAP_XY = 128
FLAG_FOUR_TEXTURES = 256
FLAG_PACK_FOUR_PARAMS_IN_TEXTURE = 512
FLAG_INVERT_GLOSINESS = 1024

# Color slots (cmaterial.h:67-180)
GLTF_COLOR_BASE = 0
GLTF_COLOR_COAT = 1
GLTF_COLOR_METAL = 2
EMISSION_COLOR = 0
GLASS_COLOR_REFLECT = 0
GLASS_COLOR_TRANSP = 1
CONDUCTOR_COLOR = 0
PLASTIC_COLOR = 0
DIFFUSE_COLOR = 0
DIELECTRIC_COLOR_REFLECT = 0
DIELECTRIC_COLOR_TRANSMIT = 1

# Custom data slots
GLTF_FLOAT_MI_FDR_INT = 0
GLTF_FLOAT_MI_FDR_EXT = 1
GLTF_FLOAT_MI_SSW = 2
GLTF_FLOAT_ALPHA = 3
GLTF_FLOAT_GLOSINESS = 4
GLTF_FLOAT_IOR = 5
GLTF_FLOAT_ROUGH_ORENNAYAR = 6
GLTF_FLOAT_REFL_COAT = 7
EMISSION_MULT = 0
GLASS_FLOAT_GLOSS_REFLECT = 0
GLASS_FLOAT_GLOSS_TRANSP = 1
GLASS_FLOAT_IOR = 2
CONDUCTOR_ROUGH_U = 0
CONDUCTOR_ROUGH_V = 1
CONDUCTOR_ETA = 2
CONDUCTOR_K = 3
PLASTIC_ROUGHNESS = 0
PLASTIC_IOR_RATIO = 1
PLASTIC_SPEC_SAMPLE_WEIGHT = 2
PLASTIC_PRECOMP_REFLECTANCE = 3
DIFFUSE_ROUGHNESS = 0
BLEND_WEIGHT = 0
DIELECTRIC_ETA_EXT = 0
DIELECTRIC_ETA_INT = 1

# Light geometry / distribution (include/clight.h:5-17)
LIGHT_GEOM_RECT = 1
LIGHT_GEOM_DISC = 2
LIGHT_GEOM_SPHERE = 3
LIGHT_GEOM_DIRECT = 4
LIGHT_GEOM_POINT = 5
LIGHT_GEOM_ENV = 6
LIGHT_DIST_LAMBERT = 0
LIGHT_DIST_OMNI = 1
LIGHT_DIST_SPOT = 2
LIGHT_FLAG_POINT_AREA = 1
LIGHT_FLAG_PROJECTIVE = 2

INVALID_ID = 0xFFFFFFFF

COLOR_DATA_SIZE = 4
CUSTOM_DATA_SIZE = 16


def _pad_shade(shade24: np.ndarray, mat_id: np.ndarray) -> np.ndarray:
    """[T,24] shading rows -> [T,32] (128-byte rows) with matId baked into
    column 24 as a float (exact for ids < 2^24); at least one row."""
    T = len(shade24)
    out = np.zeros((max(T, 1), 32), np.float32)
    out[:T, :24] = shade24
    out[:T, 24] = mat_id.astype(np.float32)
    return out


def _as_u32_float(x: int) -> float:
    """Store a uint32 bit pattern in a float slot (reference as_float)."""
    return float(np.frombuffer(np.uint32(x).tobytes(), np.float32)[0])


def _fdr(eta: float) -> float:
    """mi::fresnel_diffuse_reflectance (mi_materials.cpp:104-130)."""
    inv_eta = 1.0 / eta
    approx_1 = 0.0636 * inv_eta + (eta * (eta * -1.4399 + 0.7099) + 0.6681)
    coeffs = [0.919317, -3.4793, 6.75335, -7.80989, 4.98554, -1.36881]
    approx_2 = 0.0
    for c in reversed(coeffs):
        approx_2 = approx_2 * inv_eta + c
    return approx_1 if eta < 1.0 else approx_2


class MaterialRec:
    """Host-side mirror of the reference ``struct Material`` (cmaterial.h:187-203)."""

    def __init__(self):
        self.mtype = 0
        self.cflags = 0
        self.light_id = INVALID_ID
        self.nonlinear = 0
        self.texid = [0, 0, 0, 0]
        self.spdid = [INVALID_ID] * 4
        self.datai = [0, 0, 0, 0]
        self.colors = np.zeros((COLOR_DATA_SIZE, 4), np.float32)
        self.row0 = np.tile(np.array([1, 0, 0, 0], np.float32), (4, 1))
        self.row1 = np.tile(np.array([0, 1, 0, 0], np.float32), (4, 1))
        self.data = np.zeros(CUSTOM_DATA_SIZE, np.float32)


def set_mi_plastic(mat: MaterialRec, int_ior, ext_ior, diffuse_refl, spec_refl):
    """mi_materials.cpp:455-469."""
    mat.colors[GLTF_COLOR_BASE] = diffuse_refl
    mat.colors[GLTF_COLOR_COAT] = spec_refl
    m_eta = int_ior / ext_ior
    mat.data[GLTF_FLOAT_IOR] = m_eta
    mat.data[GLTF_FLOAT_MI_FDR_INT] = _fdr(1.0 / m_eta)
    mat.data[GLTF_FLOAT_MI_FDR_EXT] = _fdr(m_eta)
    d_mean = float(np.mean(diffuse_refl[:3]))
    s_mean = float(np.mean(spec_refl[:3]))
    mat.data[GLTF_FLOAT_MI_SSW] = s_mean / max(d_mean + s_mean, 1e-20)


# ---------------------------------------------------------------------------
# Texture cache
# ---------------------------------------------------------------------------

class TexCache:
    """Caches (xml texId, sampler state) -> pool slot, like the reference's
    texCache keyed by HydraSampler (integrator_pt_scene_tex.cpp:107-131)."""

    def __init__(self, infos: list[hydra_xml.TextureInfo]):
        self.infos = {i.tex_id: i for i in infos}
        self.pool = tex.TexturePoolBuilder()
        self.cache: dict[tuple, int] = {}

    def _load(self, info: hydra_xml.TextureInfo, srgb: bool) -> np.ndarray:
        path = info.path
        if path.endswith('.image4ub') or path.endswith('.image4f') or '.image' in path:
            return tex.decode_chunk(path, info.width, info.height, info.bpp,
                                    info.offset, srgb and info.bpp <= 4)
        return tex.load_image_file(path, srgb)

    def slot_from_node(self, color_node) -> tuple[int, np.ndarray, np.ndarray]:
        """ReadSamplerFromColorNode + LoadTextureFromNode.

        Returns (slot, row0, row1). slot==0 (white) when no texture node.
        """
        row0 = np.array([1, 0, 0, 0], np.float32)
        row1 = np.array([0, 1, 0, 0], np.float32)
        if color_node is None:
            return 0, row0, row1
        tnode = color_node.find('texture')
        if tnode is None:
            return 0, row0, row1
        tex_id = int(tnode.get('id', '0'))
        addr_u = tex.addr_mode_from_string(tnode.get('addressing_mode_u', 'wrap'))
        addr_v = tex.addr_mode_from_string(tnode.get('addressing_mode_v', 'wrap'))
        filt_s = tnode.get('filter', 'linear')
        filt = tex.FILTER_NEAREST if filt_s in ('point', 'nearest') else tex.FILTER_LINEAR
        disable_gamma = tnode.get('input_gamma') == '1'
        mat_attr = tnode.get('matrix')
        if mat_attr is not None:
            vals = [float(x) for x in mat_attr.split()]
            row0 = np.array(vals[0:4], np.float32)
            row1 = np.array(vals[4:8], np.float32)
        key = (tex_id, addr_u, addr_v, filt, disable_gamma)
        if key not in self.cache:
            info = self.infos.get(tex_id)
            if info is None:
                self.cache[key] = 0
            else:
                img = self._load(info, srgb=not disable_gamma)
                self.cache[key] = self.pool.add(img, filt, addr_u, addr_v)
        return self.cache[key], row0, row1

    def slot_from_image(self, img: np.ndarray, filt=tex.FILTER_LINEAR,
                       addr_u=tex.ADDR_CLAMP, addr_v=tex.ADDR_CLAMP) -> int:
        return self.pool.add(img, filt, addr_u, addr_v)

    def slot_by_id(self, tex_id: int) -> int:
        """LoadTextureById (integrator_pt_scene_tex.cpp:129-144): default
        sampler, gamma DISABLED — used for spectral textures."""
        key = (tex_id, tex.ADDR_WRAP, tex.ADDR_WRAP, tex.FILTER_LINEAR, True)
        if key not in self.cache:
            info = self.infos.get(tex_id)
            if info is None:
                self.cache[key] = 0
            else:
                img = self._load(info, srgb=False)
                self.cache[key] = self.pool.add(img, tex.FILTER_LINEAR,
                                                tex.ADDR_WRAP, tex.ADDR_WRAP)
        return self.cache[key]


# ---------------------------------------------------------------------------
# Material converters (integrator_pt_scene_mat.cpp)
# ---------------------------------------------------------------------------

def _read1f(node, default=0.0):
    return hydra_xml._read_val_f(node, default)


def convert_old_hydra_material(node, tc: TexCache, spectral: bool) -> MaterialRec:
    """ConvertOldHydraMaterial (integrator_pt_scene_mat.cpp:280-452)."""
    mat = MaterialRec()
    mat.mtype = MAT_TYPE_GLTF
    mat.data[GLTF_FLOAT_ALPHA] = 0.0
    mat.data[GLTF_FLOAT_REFL_COAT] = 1.0
    mat.colors[GLTF_COLOR_COAT] = (1, 1, 1, 1)
    mat.colors[GLTF_COLOR_METAL] = (0, 0, 0, 0)
    mat.data[EMISSION_MULT] = 1.0

    emiss = node.find('emission')
    color = np.zeros(4, np.float32)
    is_emission = False
    if node.get('light_id') is not None or emiss is not None:
        emiss_color_node = emiss.find('color') if emiss is not None else None
        color = hydra_xml.read_color(emiss_color_node)
        is_emission = (node.get('light_id') is not None
                       or float(np.linalg.norm(color)) > 1e-5)
        slot, r0, r1 = tc.slot_from_node(emiss_color_node)
        mat.texid[0], mat.row0[0], mat.row1[0] = slot, r0, r1
        mat.colors[EMISSION_COLOR] = color
        mat.light_id = (int(node.get('light_id'))
                        if node.get('light_id') is not None else INVALID_ID)
        if emiss_color_node is not None:
            mult_node = emiss_color_node.find('multiplier')
            mat.data[EMISSION_MULT] = _read1f(mult_node, 1.0) if mult_node is not None else 1.0
        mat.mtype = MAT_TYPE_LIGHT_SOURCE

    diff_color_node = node.find('diffuse/color')
    if diff_color_node is not None:
        color = hydra_xml.read_color(diff_color_node)
        if diff_color_node.find('texture') is not None:
            slot, r0, r1 = tc.slot_from_node(diff_color_node)
            mat.texid[0], mat.row0[0], mat.row1[0] = slot, r0, r1

    refl_color = np.zeros(4, np.float32)
    refl_gloss = 1.0
    fresnel_ior = 1.5
    refl = node.find('reflectivity')
    if refl is not None:
        refl_color = hydra_xml.read_color(refl.find('color'))
        refl_gloss = _read1f(refl.find('glossiness'), 1.0)
        fresnel_ior = _read1f(refl.find('fresnel_ior'), 1.5)

    transp_color = np.zeros(4, np.float32)
    transp_gloss, transp_ior = 1.0, 1.5
    transp = node.find('transparency')
    if transp is not None:
        transp_color = hydra_xml.read_color(transp.find('color'))
        transp_gloss = _read1f(transp.find('glossiness'), 1.0)
        transp_ior = _read1f(transp.find('ior'), 1.5)

    has_fresnel = False
    if refl is not None:
        fr = refl.find('fresnel')
        has_fresnel = fr is not None and fr.get('val') not in (None, '0')
    if not has_fresnel:
        fresnel_ior = 0.0

    ln_refl = float(np.linalg.norm(refl_color))
    ln_col3 = float(np.linalg.norm(color[:3]))

    if (ln_refl > 1e-5 and ln_col3 > 1e-5) or has_fresnel:
        mat.mtype = MAT_TYPE_GLTF
        mat.light_id = INVALID_ID
        mat.colors[GLTF_COLOR_BASE] = color
        mat.colors[GLTF_COLOR_COAT] = refl_color
        if has_fresnel:
            mat.data[GLTF_FLOAT_ALPHA] = 0.0
            mat.data[GLTF_FLOAT_REFL_COAT] = 1.0
            mat.colors[GLTF_COLOR_METAL] = (0, 0, 0, 0)
            mat.cflags = GLTF_COMPONENT_LAMBERT | GLTF_COMPONENT_COAT
            set_mi_plastic(mat, fresnel_ior, 1.0, color, refl_color)
        else:
            mat.data[GLTF_FLOAT_ALPHA] = ln_refl / (ln_refl + ln_col3)
            mat.data[GLTF_FLOAT_REFL_COAT] = 0.0
            mat.colors[GLTF_COLOR_COAT] = (0, 0, 0, 0)
            mat.colors[GLTF_COLOR_METAL] = refl_color
            mat.cflags = GLTF_COMPONENT_LAMBERT | GLTF_COMPONENT_METAL
    elif ln_refl > 1e-5:
        mat.mtype = MAT_TYPE_GLTF
        mat.cflags = GLTF_COMPONENT_METAL
        mat.colors[GLTF_COLOR_BASE] = refl_color
        mat.colors[GLTF_COLOR_METAL] = (1, 1, 1, 1)
        mat.colors[GLTF_COLOR_COAT] = (0, 0, 0, 0)
        mat.data[GLTF_FLOAT_ALPHA] = 1.0
    elif ln_col3 > 1e-5:
        mat.mtype = MAT_TYPE_GLTF
        mat.cflags = GLTF_COMPONENT_LAMBERT
        mat.colors[GLTF_COLOR_BASE] = color
        mat.colors[GLTF_COLOR_COAT] = (0, 0, 0, 0)
        mat.colors[GLTF_COLOR_METAL] = (0, 0, 0, 0)
        mat.data[GLTF_FLOAT_ALPHA] = 0.0
        mat.data[GLTF_FLOAT_REFL_COAT] = 0.0

    if float(np.linalg.norm(transp_color)) > 1e-5:
        mat.mtype = MAT_TYPE_GLASS
        mat.colors[GLTF_COLOR_BASE] = refl_color
        mat.colors[GLASS_COLOR_REFLECT] = refl_color
        mat.colors[GLASS_COLOR_TRANSP] = transp_color
        mat.data[GLASS_FLOAT_GLOSS_REFLECT] = refl_gloss
        mat.data[GLASS_FLOAT_GLOSS_TRANSP] = transp_gloss
        mat.data[GLASS_FLOAT_IOR] = fresnel_ior if fresnel_ior != 0.0 else transp_ior

    if is_emission:
        mat.mtype = MAT_TYPE_LIGHT_SOURCE

    rough_node = node.find('diffuse/roughness')
    if rough_node is not None:
        mat.data[GLTF_FLOAT_ROUGH_ORENNAYAR] = _read1f(rough_node)
        mat.cflags |= GLTF_COMPONENT_ORENNAYAR

    mat.data[GLTF_FLOAT_GLOSINESS] = refl_gloss
    mat.data[GLTF_FLOAT_IOR] = fresnel_ior if mat.mtype != MAT_TYPE_GLTF or not has_fresnel else mat.data[GLTF_FLOAT_IOR]
    if mat.mtype == MAT_TYPE_GLTF and not has_fresnel:
        mat.data[GLTF_FLOAT_IOR] = fresnel_ior
    return mat


def convert_gltf_material(node, tc: TexCache, spectral: bool) -> MaterialRec:
    """ConvertGLTFMaterial (integrator_pt_scene_mat.cpp:176-278)."""
    mat = MaterialRec()
    mat.mtype = MAT_TYPE_GLTF
    mat.cflags = GLTF_COMPONENT_LAMBERT | GLTF_COMPONENT_COAT
    mat.data[GLTF_FLOAT_ALPHA] = 0.0
    mat.data[GLTF_FLOAT_REFL_COAT] = 1.0
    mat.colors[GLTF_COLOR_COAT] = (1, 1, 1, 1)
    mat.colors[GLTF_COLOR_METAL] = (1, 1, 1, 1)
    mat.data[EMISSION_MULT] = 1.0

    fresnel_ior, refl_gloss, metalness = 1.5, 1.0, 0.0
    base_color = np.ones(4, np.float32)

    cnode = node.find('color')
    if cnode is not None:
        base_color = hydra_xml.read_color(cnode)
        if cnode.find('texture') is not None:
            slot, r0, r1 = tc.slot_from_node(cnode)
            mat.texid[0], mat.row0[0], mat.row1[0] = slot, r0, r1

    gnode = node.find('glossiness')
    rnode = node.find('roughness')
    if gnode is not None:
        refl_gloss = _read1f(gnode, 1.0)
        if gnode.find('texture') is not None:
            slot, r0, r1 = tc.slot_from_node(gnode)
            mat.texid[2], mat.row0[2], mat.row1[2] = slot, r0, r1
            mat.cflags |= FLAG_FOUR_TEXTURES
    elif rnode is not None:
        refl_gloss = _read1f(rnode, 1.0)
        mat.cflags |= FLAG_INVERT_GLOSINESS
        if rnode.find('texture') is not None:
            slot, r0, r1 = tc.slot_from_node(rnode)
            mat.texid[2], mat.row0[2], mat.row1[2] = slot, r0, r1
            mat.cflags |= FLAG_FOUR_TEXTURES

    mnode = node.find('metalness')
    if mnode is not None:
        metalness = _read1f(mnode, 0.0)
        if mnode.find('texture') is not None:
            slot, r0, r1 = tc.slot_from_node(mnode)
            mat.texid[3], mat.row0[3], mat.row1[3] = slot, r0, r1
            mat.cflags |= FLAG_FOUR_TEXTURES

    if node.find('fresnel_ior') is not None:
        fresnel_ior = _read1f(node.find('fresnel_ior'), 1.5)
    if node.find('coat') is not None:
        mat.data[GLTF_FLOAT_REFL_COAT] = _read1f(node.find('coat'), 1.0)

    gmc = node.find('glossiness_metalness_coat')
    if gmc is not None:
        val = _read1f(gmc)
        metalness = val
        refl_gloss = val
        mat.data[GLTF_FLOAT_REFL_COAT] = val
        if gmc.find('texture') is not None:
            slot, r0, r1 = tc.slot_from_node(gmc)
            mat.texid[2], mat.row0[2], mat.row1[2] = slot, r0, r1
            mat.cflags |= FLAG_FOUR_TEXTURES | FLAG_PACK_FOUR_PARAMS_IN_TEXTURE

    mat.colors[GLTF_COLOR_BASE] = base_color
    mat.colors[GLTF_COLOR_METAL] = (1, 1, 1, 1)
    mat.colors[GLTF_COLOR_COAT] = (1, 1, 1, 1)
    mat.data[GLTF_FLOAT_ALPHA] = metalness
    mat.data[GLTF_FLOAT_GLOSINESS] = refl_gloss
    mat.data[GLTF_FLOAT_IOR] = fresnel_ior
    set_mi_plastic(mat, fresnel_ior, 1.0, base_color, np.ones(4, np.float32))
    return mat


def load_rough_conductor(node, tc: TexCache, spectral: bool) -> MaterialRec:
    """LoadRoughConductorMaterial (integrator_pt_scene_mat.cpp:455-530)."""
    mat = MaterialRec()
    mat.mtype = MAT_TYPE_CONDUCTOR
    mat.colors[CONDUCTOR_COLOR] = (1, 1, 1, 1)
    alpha_u = alpha_v = 0.0
    anode = node.find('alpha')
    if anode is not None:
        alpha_u = alpha_v = float(anode.get('val', '0'))
        slot, r0, r1 = tc.slot_from_node(anode)
        if slot != 0:
            alpha_u = alpha_v = 1.0
        mat.texid[0], mat.row0[0], mat.row1[0] = slot, r0, r1
    else:
        au, av = node.find('alpha_u'), node.find('alpha_v')
        alpha_u = float(au.get('val', '0')) if au is not None else 0.0
        alpha_v = float(av.get('val', '0')) if av is not None else 0.0
    eta_node, k_node = node.find('eta'), node.find('k')
    eta = float(eta_node.get('val', '0')) if eta_node is not None else 0.0
    k = float(k_node.get('val', '0')) if k_node is not None else 0.0

    def spec_id(n):
        if n is None:
            return INVALID_ID
        s = n.find('spectrum')
        return int(s.get('id')) if s is not None else INVALID_ID

    mat.data[CONDUCTOR_ROUGH_U] = alpha_u
    mat.data[CONDUCTOR_ROUGH_V] = alpha_v
    mat.data[CONDUCTOR_ETA] = eta
    mat.data[CONDUCTOR_K] = k
    mat.spdid[0] = spec_id(eta_node)
    mat.spdid[1] = spec_id(k_node)
    return mat


def load_diffuse_material(node, tc: TexCache, spectral: bool) -> MaterialRec:
    """LoadDiffuseMaterial (integrator_pt_scene_mat.cpp:~540-580)."""
    mat = MaterialRec()
    mat.mtype = MAT_TYPE_DIFFUSE
    mat.cflags = GLTF_COMPONENT_LAMBERT
    cnode = node.find('reflectance')
    if cnode is None:
        cnode = node.find('color')
    if cnode is not None:
        mat.colors[DIFFUSE_COLOR] = hydra_xml.read_color(cnode)
        slot, r0, r1 = tc.slot_from_node(cnode)
        mat.texid[0], mat.row0[0], mat.row1[0] = slot, r0, r1
        s = cnode.find('spectrum')
        mat.spdid[0] = int(s.get('id')) if s is not None else INVALID_ID
    bsdf = node.find('bsdf')
    if bsdf is not None and bsdf.get('type') == 'oren-nayar':
        mat.cflags |= GLTF_COMPONENT_ORENNAYAR
        rough = node.find('roughness')
        mat.data[DIFFUSE_ROUGHNESS] = _read1f(rough, 0.0)
    return mat


def load_dielectric_material(node, tc: TexCache, spectral: bool) -> MaterialRec:
    """LoadDielectricMaterial (integrator_pt_scene_mat.cpp:~600-640)."""
    mat = MaterialRec()
    mat.mtype = MAT_TYPE_DIELECTRIC
    mat.colors[DIELECTRIC_COLOR_REFLECT] = (1, 1, 1, 1)
    mat.colors[DIELECTRIC_COLOR_TRANSMIT] = (1, 1, 1, 1)
    rnode = node.find('reflectance')
    if rnode is not None:
        mat.colors[DIELECTRIC_COLOR_REFLECT] = hydra_xml.read_color(rnode)
    tnode = node.find('transmittance')
    if tnode is not None:
        mat.colors[DIELECTRIC_COLOR_TRANSMIT] = hydra_xml.read_color(tnode)
    int_ior_node = node.find('int_ior')
    ext_ior_node = node.find('ext_ior')
    mat.data[DIELECTRIC_ETA_INT] = _read1f(int_ior_node, 1.5046)
    mat.data[DIELECTRIC_ETA_EXT] = _read1f(ext_ior_node, 1.000277)
    if int_ior_node is not None:
        s = int_ior_node.find('spectrum')
        mat.spdid[0] = int(s.get('id')) if s is not None else INVALID_ID
    return mat


def load_blend_material(node, tc: TexCache) -> MaterialRec:
    """LoadBlendMaterial (integrator_pt_scene_mat.cpp:~630-660)."""
    mat = MaterialRec()
    mat.mtype = MAT_TYPE_BLEND
    wnode = node.find('weight')
    mat.data[BLEND_WEIGHT] = _read1f(wnode, 0.5)
    slot, r0, r1 = tc.slot_from_node(wnode)
    mat.texid[0], mat.row0[0], mat.row1[0] = slot, r0, r1
    mat.datai[0] = int(node.get('node_top', '0'))
    mat.datai[1] = int(node.get('node_bottom', '0'))
    return mat


# ---------------------------------------------------------------------------
# The Scene pytree
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static (trace-time) scene facts — the KSPEC analog (SURVEY.md §1)."""
    width: int
    height: int
    trace_depth: int
    spp: int
    num_lights: int
    num_materials: int
    spectral_mode: bool = False
    has_motion: bool = False
    has_env_map: bool = False
    env_enable_sam: bool = False
    has_blend: bool = False
    has_cam_back: bool = False # camera-back texture (integrator_pt.cpp:578)
    has_spd_tex: bool = False  # KSPEC_SPD_TEX spectral textures
    spd_tex_max_sz: int = 0    # longest per-spectrum texture-ref list
    # 0 = CIE-XYZ (or measured-XYZ) response, 1 = measured-RGB response
    cam_response_type: int = 0
    has_cam_response_spectra: bool = False
    has_ies: bool = False      # KSPEC_LIGHT_IES
    has_proj: bool = False     # KSPEC_LIGHT_PROJECTIVE
    has_spot: bool = False
    max_blend_stack: int = 1
    has_bump: bool = False
    has_four_textures: bool = False
    # every material slot-0 texture is 1x1 -> taps folded to constants
    tex0_all_const: bool = False
    num_tris: int = 0
    use_bvh: bool = False
    # two-level BLAS/TLAS accel (CrossRT semantics): matrix-lerped motion,
    # O(mesh) memory under instancing; else the flattened world-space soup
    use_two_level: bool = False
    # soup traced by the per-ray GPU kernel (accel/traverse_gpu.py) instead
    # of the XLA oracle (intersect_bvh / intersect_brute)
    use_kernel: bool = False
    # run that kernel through the Pallas interpreter (CPU tests only)
    kernel_interpret: bool = False
    # per-bounce coherence sort of the kernel's rays (integrator_pt)
    sort_rays: bool = True
    cam_lens_radius: float = 0.0
    cam_target_dist: float = 10.0
    exposure_mult: float = 1.0
    mat_types_present: tuple = ()
    # optics simulator (KSPEC_OPTIC_SIM): static lens stack, film->scene
    # order; each element = (curvature_radius, thickness, ior, aperture_r)
    lens_lines: tuple = ()
    phys_size: tuple = (0.0, 0.0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    # materials (SoA of cmaterial.h struct Material)
    mat_mtype: jnp.ndarray      # [M] u32
    mat_cflags: jnp.ndarray     # [M] u32
    mat_nonlinear: jnp.ndarray  # [M] i32
    mat_texid: jnp.ndarray      # [M,4] i32
    mat_spdid: jnp.ndarray      # [M,4] i32
    mat_datai: jnp.ndarray      # [M,4] i32
    mat_colors: jnp.ndarray     # [M,4,4] f32
    mat_row0: jnp.ndarray       # [M,4,4] f32
    mat_row1: jnp.ndarray       # [M,4,4] f32
    mat_data: jnp.ndarray       # [M,16] f32

    # lights (SoA of clight.h struct LightSource)
    light_pos: jnp.ndarray      # [L,4]
    light_norm: jnp.ndarray     # [L,4]
    light_intensity: jnp.ndarray# [L,4]
    light_matrix: jnp.ndarray   # [L,4,4]
    light_ies_matrix: jnp.ndarray # [L,4,4]
    light_sam_row0: jnp.ndarray # [L,4]
    light_sam_row1: jnp.ndarray # [L,4]
    light_sam_row0_inv: jnp.ndarray
    light_sam_row1_inv: jnp.ndarray
    light_size: jnp.ndarray     # [L,2]
    light_pdf_a: jnp.ndarray    # [L]
    light_geom_type: jnp.ndarray# [L] i32
    light_dist_type: jnp.ndarray# [L] i32
    light_flags: jnp.ndarray    # [L] i32
    light_pdf_table_offset: jnp.ndarray # [L] i32
    light_pdf_table_size_x: jnp.ndarray # [L] i32
    light_pdf_table_size_y: jnp.ndarray # [L] i32
    light_spec_id: jnp.ndarray  # [L] i32
    light_tex_id: jnp.ndarray   # [L] i32
    light_ies_id: jnp.ndarray   # [L] i32
    light_mult: jnp.ndarray     # [L]
    light_cos1: jnp.ndarray     # [L]
    light_cos2: jnp.ndarray     # [L]

    # acceleration structure (flat skip-pointer BVH over the soup)
    bvh_bmin: jnp.ndarray       # [M,3] f32
    bvh_bmax: jnp.ndarray       # [M,3] f32
    bvh_skip: jnp.ndarray       # [M] i32
    bvh_tri_offset: jnp.ndarray # [M] i32
    bvh_tri_count: jnp.ndarray  # [M] i32

    # per-triangle baked shading rows: world-space corner normals/tangents/uv
    # packed as [T, 32] = 3 x (norm3, tx, tang3, ty) + matId(col 24) + pad
    # (128-byte rows).  ONE gather per hit replaces 8 (tri_indices x3,
    # vdata x3, norm_matrix, mat id).
    tri_shade: jnp.ndarray      # [T,32] f32
    tri_mat_id: jnp.ndarray     # [T] i32 (remap lists already applied)

    # geometry: world-space triangle soup (flattened instances, BVH leaf order)
    tri_v0: jnp.ndarray         # [T,3] f32 world-space
    tri_e1: jnp.ndarray         # [T,3] (v1-v0)
    tri_e2: jnp.ndarray         # [T,3] (v2-v0)
    tri_inst_id: jnp.ndarray    # [T] i32
    tri_geom_id: jnp.ndarray    # [T] i32
    tri_prim_id: jnp.ndarray    # [T] i32

    # motion blur: per-tri deltas to the t=1 endpoints ([0,*] when static)
    tri_dv0: jnp.ndarray        # [T,3] or [0,3]
    tri_de1: jnp.ndarray        # [T,3] or [0,3]
    tri_de2: jnp.ndarray        # [T,3] or [0,3]
    tri_shade_d: jnp.ndarray    # [T,24] or [0,24]

    # shading tables (object space, reference layout integrator_pt.h:472-492)
    tri_indices: jnp.ndarray    # [3*Tm] u32 (per-mesh concatenated)
    vdata: jnp.ndarray          # [V,8] f32: normAndTx | tangAndTy
    mat_id_by_prim: jnp.ndarray # [Tm] i32
    mat_vert_offset: jnp.ndarray# [G,2] i32 (triOffset, vertOffset)
    norm_matrices: jnp.ndarray  # [I,4,4] f32 inverse-transpose
    remap_inst: jnp.ndarray     # [I,2] i32 (remapListId, lightId)
    all_remap_lists: jnp.ndarray# [..] i32 (lists then offsets)
    all_remap_lists_size: jnp.ndarray  # scalar i32

    # shared float array (env pdf tables, plastic LUTs...)
    arrays1f: jnp.ndarray       # [..] f32

    # thin-film tables (integrator_pt.h:585-591)
    films_thickness: jnp.ndarray  # [..] f32
    films_eta_k: jnp.ndarray      # [..] f32 (etas then ks per material)
    films_spec_id: jnp.ndarray    # [..] i32
    precomp_films: jnp.ndarray    # [..] f32 R/T tables (see build_film.py)

    # spectra
    spec_values: jnp.ndarray    # [..] f32
    spec_offset_sz: jnp.ndarray # [S,2] i32
    # spectral textures (KSPEC_SPD_TEX, integrator_spectrum.cpp:127-183):
    # per-spectrum (offset, count) into the (texid, wavelength) ref lists
    spec_tex_offset_sz: jnp.ndarray  # [S,2] i32
    spec_tex_texid: jnp.ndarray      # [K] i32
    spec_tex_wl: jnp.ndarray         # [K] f32

    # environment
    env_color: jnp.ndarray      # [4]
    env_tex_id: jnp.ndarray     # i32 scalar
    env_sam_row0: jnp.ndarray   # [4]
    env_sam_row1: jnp.ndarray   # [4]
    env_light_id: jnp.ndarray   # i32 scalar
    env_spec_id: jnp.ndarray    # i32 scalar
    env_spec_mult: jnp.ndarray  # f32 scalar
    env_cam_back_id: jnp.ndarray# i32 scalar

    # camera
    proj_inv: jnp.ndarray       # [4,4]
    world_view_inv: jnp.ndarray # [4,4]
    cam_response_rgb: jnp.ndarray  # [4]
    cam_response_spec_id: jnp.ndarray  # [3] i32 (X/Y/Z response spectra)

    # textures
    textures: tex.TexturePool

    # CIE response curves for spectral mode [(L),4] (x,y,z,0)
    cie_xyz: jnp.ndarray

    # packed per-row tables: ONE fetch per material/light instead of ~10/25
    # scattered gathers
    mat_packed_f32: jnp.ndarray   # [M, 64]: colors(16) row0(16) row1(16) data(16)
    mat_packed_i32: jnp.ndarray   # [M, 16]: mtype cflags nonlinear pad texid4 spdid4 datai4 pad
    light_packed_f32: jnp.ndarray # [L, 66]
    light_packed_i32: jnp.ndarray # [L, 16]

    # const-texture fold (KSPEC-style trace-time specialization): when EVERY
    # material's slot-0 texture is a 1x1 constant, the bilinear tap reduces
    # to a per-material constant baked here
    mat_tex0_const: jnp.ndarray = None  # [M,4] f32 (None unless folded)

    # two-level accel (accel/two_level.TwoLevel) or None when using the soup
    two_level: object = None
    # the soup's BVH packed for the GPU kernel (traverse_gpu.pack) or None
    kn_nodes: jnp.ndarray = None
    kn_tris: jnp.ndarray = None


def _pad128_1d(a):
    """A 1-D f32 table padded with zeros to a multiple of 128 entries."""
    a = np.asarray(a, np.float32)
    if a.size % 128:
        a = np.concatenate([a, np.zeros(128 - a.size % 128, np.float32)])
    return a


ACCELS = ('auto', 'kernel', 'bvh', 'two_level')


def choose_accel(accel: str, platform: str, has_motion: bool, soup_T: int,
                 unique_T: int) -> tuple[bool, bool, bool]:
    """The one routing decision for a scene's traces.

    Returns ``(use_two_level, use_kernel, use_bvh)``:

    * ``'auto'``: motion and heavily instanced soups (> 200k triangles, more
      than twice the unique ones) take the XLA two-level walk; any other
      soup takes the GPU kernel on the GPU and the XLA oracle elsewhere;
    * ``'kernel'``: the GPU kernel (static soups only);
    * ``'bvh'``: the XLA oracle on any platform;
    * ``'two_level'``: the XLA two-level walk.

    ``use_bvh`` picks the oracle's BVH walk over the brute-force scan; it
    is set for soups above 512 triangles and whenever ``accel == 'bvh'``."""
    if accel not in ACCELS:
        raise ValueError(f'accel must be one of {ACCELS}, not {accel!r}')
    if accel == 'kernel' and has_motion:
        raise ValueError("accel='kernel' traces static soups; motion scenes "
                         "take the two-level walk")
    use_two_level = (accel == 'two_level'
                     or (accel == 'auto'
                         and (has_motion
                              or (soup_T > 200_000 and soup_T > 2 * unique_T))))
    use_kernel = (not use_two_level and soup_T > 0
                  and (accel == 'kernel'
                       or (accel == 'auto' and platform == 'gpu')))
    use_bvh = accel == 'bvh' or soup_T > 512
    return use_two_level, use_kernel, use_bvh


def load_scene(scene_path: str, scene_dir: str = '', spectral_mode: bool = False,
               accel: str = 'auto',
               width: Optional[int] = None, height: Optional[int] = None,
               look_at_override=None, cam_id: int = 0
               ) -> tuple[Scene, SceneMeta]:
    """Full scene load: the analog of Integrator::LoadScene (3.1/3.4 in SURVEY).

    ``look_at_override``: 16 floats, row-major world-view matrix replacing
    the scene camera's view transform (the -look_at CLI flag,
    main.cpp look-at override).  ``cam_id``: multi-camera scene selector
    (SetCamId, integrator_pt_scene.cpp:1143-1180)."""
    xml = hydra_xml.HydraScene(scene_path, scene_dir)

    settings = xml.settings()
    sett = settings[0] if settings else None
    fb_w = width or (sett.width if sett else 1024)
    fb_h = height or (sett.height if sett else 1024)
    trace_depth = (sett.depth if sett and sett.depth else 6)
    spp = (sett.spp if sett and sett.spp else 1)

    tc = TexCache(xml.textures())

    # ---- lights (LoadSceneLights, integrator_pt_scene.cpp:421-492) --------
    lights = []
    arrays1f: list[np.ndarray] = []
    arrays1f_len = 0
    env = dict(color=np.zeros(4, np.float32), tex_id=-1,
               sam_row0=np.array([1, 0, 0, 0], np.float32),
               sam_row1=np.array([0, 1, 0, 0], np.float32),
               light_id=-1, spec_id=-1, spec_mult=1.0, cam_back_id=-1,
               enable_sam=False)
    old_to_new_light = {}
    for old_id, linst in enumerate(xml.instances_lights()):
        lnode = linst.light_node
        ltype = lnode.get('type', '')
        shape = lnode.get('shape', '')
        ldist = lnode.get('distribution', '')
        m = linst.matrix
        size_x = float(lnode.find('size').get('half_width', '0')) if lnode.find('size') is not None else 0.0
        size_z = float(lnode.find('size').get('half_length', '0')) if lnode.find('size') is not None else 0.0
        inode = lnode.find('intensity')
        power = 0.0
        if inode is not None:
            mn = inode.find('multiplier')
            if mn is not None:
                power = _read1f(mn, 0.0)
        if power == 0.0:
            power = 1.0
        color = hydra_xml.read_color(inode.find('color') if inode is not None else None)
        spec_id = INVALID_ID
        if inode is not None and inode.find('color') is not None:
            s = inode.find('color').find('spectrum')
            if s is not None:
                spec_id = int(s.get('id'))

        L = dict(pos=np.zeros(4, np.float32), norm=np.array([0, -1, 0, 0], np.float32),
                 intensity=color, matrix=np.eye(4, dtype=np.float32),
                 ies_matrix=np.eye(4, dtype=np.float32),
                 sam_row0=np.array([1, 0, 0, 0], np.float32),
                 sam_row1=np.array([0, 1, 0, 0], np.float32),
                 sam_row0_inv=np.array([1, 0, 0, 0], np.float32),
                 sam_row1_inv=np.array([0, 1, 0, 0], np.float32),
                 size=np.zeros(2, np.float32), pdf_a=1.0,
                 geom_type=0, dist_type=LIGHT_DIST_LAMBERT, flags=0,
                 pdf_table_offset=0, pdf_table_size_x=0, pdf_table_size_y=0,
                 spec_id=spec_id, tex_id=-1, ies_id=-1, mult=power,
                 cos1=0.0, cos2=0.0)

        add = True
        if ltype == 'sky':
            L['geom_type'] = LIGHT_GEOM_ENV
            L['dist_type'] = LIGHT_DIST_OMNI
            env['color'] = color
            env['spec_id'] = spec_id if spec_id != INVALID_ID else -1
            env['spec_mult'] = power
            cnode = inode.find('color') if inode is not None else None
            tslot = 0
            if cnode is not None and cnode.find('texture') is not None:
                tslot, r0, r1 = tc.slot_from_node(cnode)
                env['tex_id'] = tslot
                env['sam_row0'], env['sam_row1'] = r0, r1
                L['tex_id'] = tslot
                L['sam_row0'], L['sam_row1'] = r0, r1
                tm = np.eye(4, dtype=np.float32)
                tm[0], tm[1] = np.concatenate([r0[:4]]), np.concatenate([r1[:4]])
                tmi = np.linalg.inv(tm)
                L['sam_row0_inv'], L['sam_row1_inv'] = tmi[0], tmi[1]
                # build env importance table (PdfTableFromImage,
                # integrator_pt_scene_lgt.cpp:237-270)
                key = [k for k, v in tc.cache.items() if v == tslot]
                img = None
                if key:
                    info = tc.infos.get(key[0][0])
                    if info is not None:
                        img = tc._load(info, srgb=not key[0][4])
                if img is not None and (info.path.endswith('.exr') or info.bpp > 4):
                    lum = np.max(img[..., :3], axis=-1).astype(np.float64)
                    avg = lum.mean()
                    lum = np.maximum(lum, 0.1 * avg)
                    prefix = np.zeros(lum.size + 1, np.float32)
                    prefix[1:] = np.cumsum(lum.reshape(-1))
                    L['pdf_table_offset'] = arrays1f_len
                    L['pdf_table_size_x'] = img.shape[1]
                    L['pdf_table_size_y'] = img.shape[0]
                    arrays1f.append(prefix.astype(np.float32))
                    arrays1f_len += prefix.size
                    env['light_id'] = len(lights)
                    env['enable_sam'] = True
                else:
                    add = False
            else:
                add = False
            back = lnode.find('back')
            if back is not None:
                bslot, _, _ = tc.slot_from_node(back)
                env['cam_back_id'] = bslot
        elif ltype == 'directional':
            L['pos'] = m @ np.array([0, 0, 0, 1], np.float32)
            nrm = m @ np.array([0, -1, 0, 0], np.float32)
            L['norm'] = nrm / max(np.linalg.norm(nrm[:3]), 1e-20)
            L['geom_type'] = LIGHT_GEOM_DIRECT
        elif shape in ('rect', 'disk'):
            L['pos'] = m @ np.array([0, 0, 0, 1], np.float32)
            nrm = m @ np.array([0, -1, 0, 0], np.float32)
            L['norm'] = nrm / max(np.linalg.norm(nrm[:3]), 1e-20)
            L['geom_type'] = LIGHT_GEOM_RECT if shape == 'rect' else LIGHT_GEOM_DISC
            scale = np.array([np.linalg.norm(m[:3, i]) for i in range(3)])
            mm = m.copy()
            mm[:3, 3] = 0
            L['matrix'] = mm
            L['size'] = np.array([size_z, size_x], np.float32)  # note ZX swap
            if shape == 'disk':
                radius = float(lnode.find('size').get('radius', '0'))
                L['size'][0] = radius
                L['pdf_a'] = 1.0 / (np.pi * radius * radius * scale[0] * scale[2])
            else:
                L['pdf_a'] = 1.0 / (4.0 * L['size'][0] * L['size'][1] * scale[0] * scale[2])
        elif shape == 'sphere':
            radius = float(lnode.find('size').get('radius', '0'))
            scale = np.array([np.linalg.norm(m[:3, i]) for i in range(3)])
            radius *= scale[0]
            L['pos'] = m @ np.array([0, 0, 0, 1], np.float32)
            L['geom_type'] = LIGHT_GEOM_SPHERE
            L['size'] = np.array([radius, radius], np.float32)
            L['pdf_a'] = 1.0 / (4.0 * np.pi * radius * radius)
        elif shape == 'point':
            L['pos'] = m @ np.array([0, 0, 0, 1], np.float32)
            nrm = m @ np.array([0, -1, 0, 0], np.float32)
            L['norm'] = nrm / max(np.linalg.norm(nrm[:3]), 1e-20)
            L['geom_type'] = LIGHT_GEOM_POINT
            L['dist_type'] = (LIGHT_DIST_OMNI if ldist in ('uniform', 'omni', 'ies')
                              else LIGHT_DIST_LAMBERT)
            L['pdf_a'] = 1.0
            if ldist == 'spot':
                angle1 = _read1f(lnode.find('falloff_angle'))
                angle2 = _read1f(lnode.find('falloff_angle2'))
                L['cos2'] = float(np.cos(0.5 * np.pi / 180.0 * angle1))
                L['cos1'] = float(np.cos(0.5 * np.pi / 180.0 * angle2))
                L['dist_type'] = LIGHT_DIST_SPOT
        # IES profile
        ies_node = lnode.find('ies')
        if ies_node is not None:
            from . import ies as ies_mod
            ies_path = os.path.join(xml.scene_dir, ies_node.get('loc', ''))
            try:
                sph = ies_mod.ies_to_spherical_texture(ies_path)
                mx = sph.max()
                sph = sph / (mx if mx > 0 else 1.0)
                img = np.stack([sph, sph, sph, np.ones_like(sph)], axis=-1)
                L['ies_id'] = tc.slot_from_image(img.astype(np.float32))
                mattr = ies_node.get('matrix')
                if mattr is not None:
                    mrot = np.array([[0, 0, 1, 0], [0, 1, 0, 0],
                                     [-1, 0, 0, 0], [0, 0, 0, 1]], np.float32)
                    mfn = np.array([float(x) for x in mattr.split()],
                                   np.float32).reshape(4, 4)
                    inst_m = m.copy()
                    inst_m[:3, 3] = 0
                    L['ies_matrix'] = mrot @ (inst_m.T @ mfn).T
                    L['ies_matrix'][:3, 3] = 0
                if ies_node.get('point_area', '0') != '0':
                    L['flags'] |= LIGHT_FLAG_POINT_AREA
            except Exception as e:  # noqa: BLE001 - missing IES falls back to none
                print(f'[load_scene]: IES load failed for {ies_path}: {e}')

        if add:
            old_to_new_light[old_id] = len(lights)
            lights.append(L)

    # ---- spectra first: film precompute needs them ------------------------
    # (LoadSceneSpectrumData runs before materials in the reference too,
    # integrator_pt_scene.cpp:959-1010)
    from . import spd
    (spec_values, spec_offset_sz, spec_tex_offset_sz, spec_tex_texid,
     spec_tex_wl) = spd.load_scene_spectra(xml.spectra())
    has_spd_tex = bool((spec_tex_offset_sz[:, 1] > 0).any())
    spd_tex_max_sz = int(spec_tex_offset_sz[:, 1].max()) if has_spd_tex else 0
    # remap spectral-texture XML ids to pool slots (LoadSpectralTextures,
    # integrator_pt_scene_mat.cpp:145-173; gamma disabled per LoadTextureById)
    if has_spd_tex:
        spec_tex_texid = np.array(
            [tc.slot_by_id(int(t)) for t in spec_tex_texid], np.int32)

    # ---- materials --------------------------------------------------------
    from . import build_film
    film_state = build_film.FilmState()
    materials: list[MaterialRec] = []
    mat_types_present = set()
    for node in xml.material_nodes():
        mtype_str = node.get('type', '')
        if mtype_str == 'hydra_material':
            mat = convert_old_hydra_material(node, tc, spectral_mode)
        elif mtype_str == 'gltf':
            mat = convert_gltf_material(node, tc, spectral_mode)
        elif mtype_str == 'rough_conductor':
            mat = load_rough_conductor(node, tc, spectral_mode)
        elif mtype_str == 'diffuse':
            mat = load_diffuse_material(node, tc, spectral_mode)
        elif mtype_str == 'dielectric':
            mat = load_dielectric_material(node, tc, spectral_mode)
        elif mtype_str == 'blend':
            mat = load_blend_material(node, tc)
        elif mtype_str == 'plastic':
            from . import build_plastic
            mat, arrays1f_len = build_plastic.load_plastic_material(
                node, tc, spectral_mode, arrays1f, arrays1f_len)
        elif mtype_str == 'thin_film':
            mat = build_film.load_thin_film_material(
                node, tc, spectral_mode, film_state, spec_values,
                spec_offset_sz)
        else:
            # unknown -> gray lambert placeholder, same shape as reference default
            mat = MaterialRec()
            mat.mtype = MAT_TYPE_GLTF
            mat.cflags = GLTF_COMPONENT_LAMBERT
            mat.colors[GLTF_COLOR_BASE] = (0.5, 0.5, 0.5, 0.0)
        # light-material intensity sync (integrator_pt_scene.cpp:575-600)
        if node.get('light_id') is not None:
            light_id = int(node.get('light_id'))
            if light_id in old_to_new_light:
                nl = old_to_new_light[light_id]
                mat.colors[EMISSION_COLOR] = lights[nl]['intensity']
                mat.data[EMISSION_MULT] = lights[nl]['mult']
                mat.spdid[0] = lights[nl]['spec_id']
        # normal map (integrator_pt_scene.cpp:603-643)
        mat.texid[1] = INVALID_ID
        disp = node.find('displacement')
        if disp is not None and disp.get('type') == 'normal_bump':
            nm = disp.find('normal_map')
            if nm is not None:
                slot, r0, r1 = tc.slot_from_node(nm)
                mat.texid[1], mat.row0[1], mat.row1[1] = slot, r0, r1
                inv = nm.find('invert')
                if inv is not None:
                    if inv.get('x') == '1':
                        mat.cflags |= FLAG_NMAP_INVERT_X
                    if inv.get('y') == '1':
                        mat.cflags |= FLAG_NMAP_INVERT_Y
                    if inv.get('swap_xy') == '1':
                        mat.cflags |= FLAG_NMAP_SWAP_XY
        materials.append(mat)
        mat_types_present.add(mat.mtype)

    if not materials:
        materials.append(MaterialRec())

    # ---- camera (LoadSceneCamera, integrator_pt_scene.cpp:645-726) --------
    from ..utils import lmath
    cam_response_type = 0
    cam_response_ids = [-1, -1, -1]
    cam_response_rgb = np.array([1, 1, 1, 1], np.float32)
    cams = xml.cameras()
    cam = (cams[cam_id] if cams and 0 <= cam_id < len(cams)
           else (cams[0] if cams else None))
    aspect = float(fb_w) / float(fb_h)
    if cam is not None:
        proj = lmath.perspective_matrix(cam.fov, aspect, cam.near_plane, cam.far_plane)
        if cam.has_matrix:
            c2w = cam.matrix.copy()
            c2w[:, 0] *= -1
            c2w[:, 2] *= -1
            world_view = np.linalg.inv(c2w).astype(np.float32)
        else:
            world_view = lmath.look_at(cam.pos, cam.look_at, cam.up)
        exposure = cam.exposure_mult
        cam_target_dist = float(np.linalg.norm(np.asarray(cam.look_at) - np.asarray(cam.pos)))
        lens_radius = 0.0
        dof = cam.node.find('enable_dof')
        if dof is not None and int(_read1f(dof)) != 0:
            lr = cam.node.find('dof_lens_radius')
            lens_radius = _read1f(lr, 0.0)
        # sensor response (integrator_pt_scene.cpp:688-711): measured
        # camera response spectra (spectral mode) or an RGB multiplier
        sensor = cam.node.find('sensor')
        if sensor is not None and sensor.find('response') is not None:
            resp = sensor.find('response')
            cam_response_type = 0 if (resp.get('type') or 'xyz').lower() == 'xyz' else 1
            sids = [int(sp.get('id', '-1')) for sp in resp.findall('spectrum')][:3]
            cam_response_ids = (sids + [-1, -1, -1])[:3]
            cnode = resp.find('color')
            if cnode is not None and cnode.get('val'):
                cam_response_rgb = np.array(
                    [float(x) for x in cnode.get('val').split()][:3] + [1.0],
                    np.float32)
        # optics simulator: full lens stack (LoadOpticsFromNode,
        # integrator_pt_scene.cpp:1078-1141). Static per scene -> lives in
        # SceneMeta so XLA constant-folds the element loop.
        optic_node = cam.node.find('optical_system')
        if optic_node is None:
            optic_node = cam.node.find('optics')
        lens_lines, phys_size = (), (0.0, 0.0)
        if optic_node is not None:
            scale = float(optic_node.get('scale', '1.0'))
            diagonal = float(optic_node.get('sensor_diagonal', '0.035'))
            px = 2.0 * float(np.sqrt(diagonal * diagonal / (1.0 + aspect * aspect)))
            phys_size = (px, aspect * px)
            rows = []
            for cur_id, line in enumerate(optic_node.findall('line')):
                lid = int(line.get('id', str(cur_id)))
                aper = line.get('semi_diameter', line.get('aperture_radius', '0'))
                rows.append((lid,
                             (scale * float(line.get('curvature_radius', '0')),
                              scale * float(line.get('thickness', '0')),
                              float(line.get('ior', '0')),
                              scale * float(aper))))
            rev = optic_node.get('order') == 'scene_to_sensor'
            rows.sort(key=lambda r: r[0], reverse=rev)
            lens_lines = tuple(r[1] for r in rows)
    else:
        proj = lmath.perspective_matrix(45.0, aspect, 0.01, 100.0)
        world_view = np.eye(4, dtype=np.float32)
        exposure, cam_target_dist, lens_radius = 1.0, 10.0, 0.0
        lens_lines, phys_size = (), (0.0, 0.0)
    if look_at_override is not None:
        # -look_at: row-major 4x4 view matrix override (user_guide.md:66-68)
        world_view = np.asarray(look_at_override,
                                np.float32).reshape(4, 4)
    proj_inv = np.linalg.inv(proj).astype(np.float32)
    world_view_inv = np.linalg.inv(world_view).astype(np.float32)

    def _custom_geom_box(node):
        """AABB stand-in mesh for custom geometry (see loop below)."""
        def vec3(attr, default):
            raw = node.get(attr)
            if not raw:
                return np.array(default, np.float32)
            return np.array([float(x) for x in raw.split()][:3], np.float32)

        lo = vec3('bbox_min', (-0.5, -0.5, -0.5))
        hi = vec3('bbox_max', (0.5, 0.5, 0.5))
        corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                            [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
                            [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                            [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]],
                           np.float32)
        faces = np.array([  # outward CCW box faces
            [0, 2, 3], [0, 3, 1], [4, 5, 7], [4, 7, 6],
            [0, 1, 5], [0, 5, 4], [2, 6, 7], [2, 7, 3],
            [0, 4, 6], [0, 6, 2], [1, 3, 7], [1, 7, 5]], np.int64)
        v_pos = np.concatenate([corners, np.ones((8, 1), np.float32)], 1)
        n = np.zeros((8, 4), np.float32)
        c = (lo + hi) * 0.5
        nrm = corners - c[None]
        nl = np.linalg.norm(nrm, axis=1, keepdims=True)
        n[:, :3] = nrm / np.maximum(nl, 1e-9)
        mat_id = int(node.get('mat_id', '0'))
        return vsgf.SimpleMesh(
            v_pos=v_pos, v_norm=n, v_tang=np.zeros((8, 4), np.float32),
            v_texc=np.zeros((8, 2), np.float32),
            indices=faces.reshape(-1).astype(np.uint32),
            mat_indices=np.full(12, mat_id, np.uint32))

    # ---- geometry (LoadSceneGeometry, integrator_pt_scene.cpp:727-837) ----
    meshes = []
    tri_indices = []
    vdata = []
    mat_id_by_prim = []
    mat_vert_offset = []
    tri_off = 0
    vert_off = 0
    for mi in xml.geom_nodes():
        if mi.tag != 'mesh':
            # custom (non-mesh) geometry passthrough (integrator_pt_scene.
            # cpp:818-831): the reference registers an opaque AABB prim via
            # AddCustomGeom_FromFile with ONE material id and a fake
            # triangle.  We stand in a 12-triangle box over the declared
            # bounds (bbox attributes when present, else a unit box) so
            # such scenes LOAD and the prim shades with its material
            # (gray lambert by default) instead of erroring out.
            mesh = _custom_geom_box(mi.node)
        else:
            mesh = vsgf.load_vsgf(mi.path)
        meshes.append(mesh)
        mat_vert_offset.append((tri_off, vert_off))
        tri_indices.append(mesh.indices)
        mat_id_by_prim.append(mesh.mat_indices)
        vd = np.zeros((len(mesh.v_pos), 8), np.float32)
        vd[:, 0:3] = mesh.v_norm[:, :3]
        vd[:, 3] = mesh.v_texc[:, 0]
        vd[:, 4:7] = mesh.v_tang[:, :3]
        vd[:, 7] = mesh.v_texc[:, 1]
        vdata.append(vd)
        tri_off += len(mesh.mat_indices)
        vert_off += len(mesh.v_pos)

    # ---- instances (LoadSceneInstances, integrator_pt_scene.cpp:839-907) --
    instances = xml.instances_geom()
    remap_lists_raw = xml.remap_lists()
    norm_matrices = []
    remap_inst = []
    tri_v0, tri_e1, tri_e2 = [], [], []
    tri_inst_id, tri_geom_id, tri_prim_id = [], [], []
    tri_shade_l, tri_mat_l = [], []
    has_motion = any(i.has_motion for i in instances)
    tri_dv0, tri_de1, tri_de2, tri_shade_d_l = [], [], [], []
    for real_id, inst in enumerate(instances):
        mesh = meshes[inst.geom_id]
        m = inst.matrix
        nm = np.linalg.inv(m).T.astype(np.float32)
        norm_matrices.append(nm)
        light_id = old_to_new_light.get(inst.light_inst_id, -1) if inst.light_inst_id >= 0 else -1
        remap_inst.append((inst.rmap_id, light_id))
        # world-space soup
        pos = mesh.v_pos[:, :3] @ m[:3, :3].T + m[:3, 3]
        idx = mesh.indices.reshape(-1, 3).astype(np.int64)
        v0 = pos[idx[:, 0]]
        v1 = pos[idx[:, 1]]
        v2 = pos[idx[:, 2]]
        tri_v0.append(v0)
        tri_e1.append(v1 - v0)
        tri_e2.append(v2 - v0)
        nt = len(idx)
        tri_inst_id.append(np.full(nt, real_id, np.int32))
        tri_geom_id.append(np.full(nt, inst.geom_id, np.int32))
        tri_prim_id.append(np.arange(nt, dtype=np.int32))

        # baked per-triangle shading rows (world-space, see Scene.tri_shade)
        def shade_rows(nmat):
            wnorm = mesh.v_norm[:, :3] @ nmat[:3, :3].T
            wtang = mesh.v_tang[:, :3] @ nmat[:3, :3].T
            sh = np.zeros((nt, 24), np.float32)
            for c in range(3):
                vi = idx[:, c]
                sh[:, c * 8 + 0:c * 8 + 3] = wnorm[vi]
                sh[:, c * 8 + 3] = mesh.v_texc[vi, 0]
                sh[:, c * 8 + 4:c * 8 + 7] = wtang[vi]
                sh[:, c * 8 + 7] = mesh.v_texc[vi, 1]
            return sh

        shade = shade_rows(nm)
        tri_shade_l.append(shade)

        if has_motion:
            # motion endpoints: second transform (matrix_motion) gives the
            # t=1 soup + shading rows; intersection lerps per ray time
            # (RayQuery_NearestHitMotion; normals integrator_pt.cpp:285-292)
            m2 = inst.matrix_motion if inst.has_motion else m
            nm2 = np.linalg.inv(m2).T.astype(np.float32)
            pos2 = mesh.v_pos[:, :3] @ m2[:3, :3].T + m2[:3, 3]
            w0 = pos2[idx[:, 0]]
            w1 = pos2[idx[:, 1]]
            w2 = pos2[idx[:, 2]]
            tri_dv0.append(w0 - v0)
            tri_de1.append((w1 - w0) - (v1 - v0))
            tri_de2.append((w2 - w0) - (v2 - v0))
            tri_shade_d_l.append(shade_rows(nm2) - shade)
        # material ids with the instance's remap list applied at build time
        mids = mesh.mat_indices.astype(np.int64)
        if inst.rmap_id >= 0 and inst.rmap_id < len(remap_lists_raw):
            rl = remap_lists_raw[inst.rmap_id]
            remap = {rl[i]: rl[i + 1] for i in range(0, len(rl) - 1, 2)}
            mids = np.array([remap.get(int(x), int(x)) for x in mids], np.int64)
        tri_mat_l.append(mids.astype(np.int32))

    # ---- acceleration structure (CommitScene analog) ----------------------
    soup_T = sum(len(v) for v in tri_v0)
    use_two_level, use_kernel, use_bvh = choose_accel(
        accel, jax.default_backend(), has_motion, soup_T, tri_off)
    two_level_obj = None
    if use_two_level:
        from ..accel import two_level as TL2
        mesh_tris = []
        for mesh in meshes:
            idx = mesh.indices.reshape(-1, 3).astype(np.int64)
            p = mesh.v_pos[:, :3]
            mv0 = p[idx[:, 0]]
            mesh_tris.append((mv0, p[idx[:, 1]] - mv0, p[idx[:, 2]] - mv0))
        inst_descs = [dict(geom_id=i.geom_id, m0=i.matrix,
                           m1=(i.matrix_motion if i.has_motion else None))
                      for i in instances]
        tl_np = TL2.build_two_level(mesh_tris, inst_descs)
        two_level_obj = jax.tree_util.tree_map(jnp.asarray, tl_np)

    from ..accel import build_bvh
    soup_v0 = np.concatenate(tri_v0) if tri_v0 else np.zeros((0, 3), np.float32)
    soup_e1 = np.concatenate(tri_e1) if tri_e1 else np.zeros((0, 3), np.float32)
    soup_e2 = np.concatenate(tri_e2) if tri_e2 else np.zeros((0, 3), np.float32)
    soup_inst = np.concatenate(tri_inst_id) if tri_inst_id else np.zeros(0, np.int32)
    soup_geom = np.concatenate(tri_geom_id) if tri_geom_id else np.zeros(0, np.int32)
    soup_prim = np.concatenate(tri_prim_id) if tri_prim_id else np.zeros(0, np.int32)
    soup_shade = (np.concatenate(tri_shade_l) if tri_shade_l
                  else np.zeros((0, 24), np.float32))
    soup_mat = np.concatenate(tri_mat_l) if tri_mat_l else np.zeros(0, np.int32)
    if has_motion and tri_dv0:
        soup_dv0 = np.concatenate(tri_dv0)
        soup_de1 = np.concatenate(tri_de1)
        soup_de2 = np.concatenate(tri_de2)
        soup_shade_d = np.concatenate(tri_shade_d_l)
    else:
        soup_dv0 = np.zeros((0, 3), np.float32)
        soup_de1 = np.zeros((0, 3), np.float32)
        soup_de2 = np.zeros((0, 3), np.float32)
        soup_shade_d = np.zeros((0, 24), np.float32)
    if use_two_level and soup_T > 1_000_000:
        # instanced giant scene: drop the soup entirely (the Whitted/gbuffer
        # soup path would need two-level wiring to run such scenes)
        z3 = np.zeros((1, 3), np.float32)
        soup_v0, soup_e1, soup_e2 = z3, z3, z3
        soup_inst = soup_geom = soup_prim = np.zeros(1, np.int32)
        soup_shade = np.zeros((1, 24), np.float32)
        soup_mat = np.zeros(1, np.int32)
        soup_dv0 = soup_de1 = soup_de2 = np.zeros((0, 3), np.float32)
        soup_shade_d = np.zeros((0, 24), np.float32)
    kn_arrays = None
    if len(soup_v0) > 0:
        motion_end = ((soup_v0 + soup_dv0, soup_e1 + soup_de1,
                       soup_e2 + soup_de2) if has_motion and len(soup_dv0)
                      else None)
        bvh = build_bvh.build(soup_v0, soup_e1, soup_e2,
                              motion_end=motion_end)
        order = bvh.order
        soup_v0, soup_e1, soup_e2 = soup_v0[order], soup_e1[order], soup_e2[order]
        soup_inst, soup_geom, soup_prim = soup_inst[order], soup_geom[order], soup_prim[order]
        soup_shade, soup_mat = soup_shade[order], soup_mat[order]
        if len(soup_dv0):
            soup_dv0, soup_de1, soup_de2 = (soup_dv0[order], soup_de1[order],
                                            soup_de2[order])
            soup_shade_d = soup_shade_d[order]
        bvh_arrays = (bvh.bmin, bvh.bmax, bvh.skip, bvh.tri_offset, bvh.tri_count)
        if use_kernel:
            from ..accel import traverse_gpu
            kn_arrays = traverse_gpu.pack(*bvh_arrays, soup_v0, soup_e1,
                                          soup_e2)
    else:
        bvh_arrays = (np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                      np.full(1, -1, np.int32), np.zeros(1, np.int32),
                      np.zeros(1, np.int32))

    # ---- remap lists (LoadSceneRemapLists) --------------------------------
    all_lists = []
    offsets = []
    for rl in xml.remap_lists():
        offsets.append(len(all_lists))
        all_lists.extend(rl)
    offsets.append(len(all_lists))
    all_remap_size = len(all_lists)
    all_remap = np.array(all_lists + offsets, np.int32) if (all_lists or offsets) else np.zeros(1, np.int32)

    # ---- CIE curves -------------------------------------------------------
    from ..ops import spectrum as spec_mod
    cie = spec_mod.cie_xyz_table()

    pool = tc.pool.finish()
    film_arrays = film_state.arrays()

    # ---- const-texture fold (trace-time KSPEC analog) ----------------------
    # If every material's slot-0 texture is a 1x1 constant, bake the tap
    # result per material and skip the bilinear texture tap.
    tex0_all_const = True
    mat_tex0_const = np.ones((len(materials), 4), np.float32)
    for i, m_ in enumerate(materials):
        t0 = int(np.int64(m_.texid[0]) & 0xFFFFFFFF)
        if t0 == INVALID_ID or t0 >= len(tc.pool._table):
            t0 = 0  # _clamp_tex: invalid -> white dummy slot
        cval = tc.pool.slot_const_value(t0)
        if cval is None:
            tex0_all_const = False
            break
        mat_tex0_const[i] = cval

    # ---- packed tables (gather-count optimization; see Scene docstring) ---
    M_ = len(materials)
    mat_pf = np.zeros((M_, 64), np.float32)
    mat_pi = np.zeros((M_, 16), np.int32)
    for i, m_ in enumerate(materials):
        mat_pf[i, 0:16] = m_.colors.reshape(-1)
        mat_pf[i, 16:32] = m_.row0.reshape(-1)
        mat_pf[i, 32:48] = m_.row1.reshape(-1)
        mat_pf[i, 48:64] = m_.data
        mat_pi[i, 0] = np.int32(np.uint32(m_.mtype))
        mat_pi[i, 1] = np.int32(np.uint32(m_.cflags))
        mat_pi[i, 2] = m_.nonlinear
        mat_pi[i, 4:8] = np.array(m_.texid, np.int64).astype(np.uint32).astype(np.int32)
        mat_pi[i, 8:12] = np.array(m_.spdid, np.int64).astype(np.uint32).astype(np.int32)
        mat_pi[i, 12:16] = np.array(m_.datai, np.int64).astype(np.uint32).astype(np.int32)

    L_ = max(len(lights), 1)
    lgt_pf = np.zeros((L_, 66), np.float32)
    lgt_pi = np.zeros((L_, 16), np.int32)
    for i, l in enumerate(lights):
        lgt_pf[i, 0:4] = l['pos']
        lgt_pf[i, 4:8] = l['norm']
        lgt_pf[i, 8:12] = l['intensity']
        lgt_pf[i, 12:28] = np.asarray(l['matrix'], np.float32).reshape(-1)
        lgt_pf[i, 28:44] = np.asarray(l['ies_matrix'], np.float32).reshape(-1)
        lgt_pf[i, 44:48] = l['sam_row0']
        lgt_pf[i, 48:52] = l['sam_row1']
        lgt_pf[i, 52:56] = l['sam_row0_inv']
        lgt_pf[i, 56:60] = l['sam_row1_inv']
        lgt_pf[i, 60:62] = l['size']
        lgt_pf[i, 62] = l['pdf_a']
        lgt_pf[i, 63] = l['mult']
        lgt_pf[i, 64] = l['cos1']
        lgt_pf[i, 65] = l['cos2']
        lgt_pi[i, 0] = l['geom_type']
        lgt_pi[i, 1] = l['dist_type']
        lgt_pi[i, 2] = l['flags']
        lgt_pi[i, 3] = l['pdf_table_offset']
        lgt_pi[i, 4] = l['pdf_table_size_x']
        lgt_pi[i, 5] = l['pdf_table_size_y']
        lgt_pi[i, 6] = np.int32(np.uint32(l['spec_id'])) if l['spec_id'] >= 0 else -1
        lgt_pi[i, 7] = l['tex_id']
        lgt_pi[i, 8] = l['ies_id']

    def cat(xs, width=None, dtype=np.float32):
        if xs:
            return np.concatenate(xs, axis=0)
        return np.zeros((0,) if width is None else (0, width), dtype)

    M = len(materials)
    scene = Scene(
        mat_mtype=jnp.asarray(np.array([m_.mtype for m_ in materials], np.uint32)),
        mat_cflags=jnp.asarray(np.array([m_.cflags for m_ in materials], np.uint32)),
        mat_nonlinear=jnp.asarray(np.array([m_.nonlinear for m_ in materials], np.int32)),
        mat_texid=jnp.asarray(np.array([m_.texid for m_ in materials], np.int64).astype(np.int32)),
        mat_spdid=jnp.asarray(np.array([m_.spdid for m_ in materials], np.int64).astype(np.uint32).astype(np.int32)),
        mat_datai=jnp.asarray(np.array([m_.datai for m_ in materials], np.int64).astype(np.int32)),
        mat_colors=jnp.asarray(np.stack([m_.colors for m_ in materials])),
        mat_row0=jnp.asarray(np.stack([m_.row0 for m_ in materials])),
        mat_row1=jnp.asarray(np.stack([m_.row1 for m_ in materials])),
        mat_data=jnp.asarray(np.stack([m_.data for m_ in materials])),
        light_pos=jnp.asarray(np.stack([l['pos'] for l in lights]) if lights else np.zeros((1, 4), np.float32)),
        light_norm=jnp.asarray(np.stack([l['norm'] for l in lights]) if lights else np.zeros((1, 4), np.float32)),
        light_intensity=jnp.asarray(np.stack([l['intensity'] for l in lights]) if lights else np.zeros((1, 4), np.float32)),
        light_matrix=jnp.asarray(np.stack([l['matrix'] for l in lights]) if lights else np.zeros((1, 4, 4), np.float32)),
        light_ies_matrix=jnp.asarray(np.stack([l['ies_matrix'] for l in lights]) if lights else np.zeros((1, 4, 4), np.float32)),
        light_sam_row0=jnp.asarray(np.stack([l['sam_row0'] for l in lights]) if lights else np.zeros((1, 4), np.float32)),
        light_sam_row1=jnp.asarray(np.stack([l['sam_row1'] for l in lights]) if lights else np.zeros((1, 4), np.float32)),
        light_sam_row0_inv=jnp.asarray(np.stack([l['sam_row0_inv'] for l in lights]) if lights else np.zeros((1, 4), np.float32)),
        light_sam_row1_inv=jnp.asarray(np.stack([l['sam_row1_inv'] for l in lights]) if lights else np.zeros((1, 4), np.float32)),
        light_size=jnp.asarray(np.stack([l['size'] for l in lights]) if lights else np.zeros((1, 2), np.float32)),
        light_pdf_a=jnp.asarray(np.array([l['pdf_a'] for l in lights], np.float32) if lights else np.ones(1, np.float32)),
        light_geom_type=jnp.asarray(np.array([l['geom_type'] for l in lights], np.int32) if lights else np.zeros(1, np.int32)),
        light_dist_type=jnp.asarray(np.array([l['dist_type'] for l in lights], np.int32) if lights else np.zeros(1, np.int32)),
        light_flags=jnp.asarray(np.array([l['flags'] for l in lights], np.int32) if lights else np.zeros(1, np.int32)),
        light_pdf_table_offset=jnp.asarray(np.array([l['pdf_table_offset'] for l in lights], np.int32) if lights else np.zeros(1, np.int32)),
        light_pdf_table_size_x=jnp.asarray(np.array([l['pdf_table_size_x'] for l in lights], np.int32) if lights else np.zeros(1, np.int32)),
        light_pdf_table_size_y=jnp.asarray(np.array([l['pdf_table_size_y'] for l in lights], np.int32) if lights else np.zeros(1, np.int32)),
        light_spec_id=jnp.asarray(np.array([np.int32(np.uint32(l['spec_id'])) for l in lights], np.int32) if lights else np.zeros(1, np.int32)),
        light_tex_id=jnp.asarray(np.array([l['tex_id'] for l in lights], np.int32) if lights else np.zeros(1, np.int32)),
        light_ies_id=jnp.asarray(np.array([l['ies_id'] for l in lights], np.int32) if lights else np.zeros(1, np.int32)),
        light_mult=jnp.asarray(np.array([l['mult'] for l in lights], np.float32) if lights else np.ones(1, np.float32)),
        light_cos1=jnp.asarray(np.array([l['cos1'] for l in lights], np.float32) if lights else np.zeros(1, np.float32)),
        light_cos2=jnp.asarray(np.array([l['cos2'] for l in lights], np.float32) if lights else np.zeros(1, np.float32)),
        bvh_bmin=jnp.asarray(bvh_arrays[0]),
        bvh_bmax=jnp.asarray(bvh_arrays[1]),
        bvh_skip=jnp.asarray(bvh_arrays[2]),
        bvh_tri_offset=jnp.asarray(bvh_arrays[3]),
        bvh_tri_count=jnp.asarray(bvh_arrays[4]),
        tri_shade=jnp.asarray(_pad_shade(soup_shade, soup_mat)),
        tri_mat_id=jnp.asarray(soup_mat),
        tri_v0=jnp.asarray(soup_v0),
        tri_e1=jnp.asarray(soup_e1),
        tri_e2=jnp.asarray(soup_e2),
        tri_inst_id=jnp.asarray(soup_inst),
        tri_geom_id=jnp.asarray(soup_geom),
        tri_prim_id=jnp.asarray(soup_prim),
        tri_dv0=jnp.asarray(soup_dv0),
        tri_de1=jnp.asarray(soup_de1),
        tri_de2=jnp.asarray(soup_de2),
        tri_shade_d=jnp.asarray(
            _pad_shade(soup_shade_d, np.zeros(len(soup_shade_d), np.int32))
            if len(soup_shade_d) else soup_shade_d.reshape(0, 32)),
        tri_indices=jnp.asarray(cat(tri_indices, dtype=np.uint32).astype(np.int32)),
        vdata=jnp.asarray(cat(vdata, 8)),
        mat_id_by_prim=jnp.asarray(cat(mat_id_by_prim, dtype=np.uint32).astype(np.int32)),
        mat_vert_offset=jnp.asarray(np.array(mat_vert_offset, np.int32) if mat_vert_offset else np.zeros((1, 2), np.int32)),
        norm_matrices=jnp.asarray(np.stack(norm_matrices) if norm_matrices else np.zeros((1, 4, 4), np.float32)),
        remap_inst=jnp.asarray(np.array(remap_inst, np.int32) if remap_inst else np.full((1, 2), -1, np.int32)),
        all_remap_lists=jnp.asarray(all_remap),
        all_remap_lists_size=jnp.asarray(np.int32(all_remap_size)),
        arrays1f=jnp.asarray(_pad128_1d(np.concatenate(arrays1f) if arrays1f
                                        else np.zeros(1, np.float32))),
        films_thickness=jnp.asarray(film_arrays[0]),
        films_eta_k=jnp.asarray(film_arrays[1]),
        films_spec_id=jnp.asarray(film_arrays[2]),
        precomp_films=jnp.asarray(film_arrays[3]),
        spec_values=jnp.asarray(spec_values),
        spec_offset_sz=jnp.asarray(spec_offset_sz),
        spec_tex_offset_sz=jnp.asarray(spec_tex_offset_sz),
        spec_tex_texid=jnp.asarray(spec_tex_texid),
        spec_tex_wl=jnp.asarray(spec_tex_wl),
        env_color=jnp.asarray(env['color']),
        env_tex_id=jnp.asarray(np.int32(env['tex_id'])),
        env_sam_row0=jnp.asarray(env['sam_row0']),
        env_sam_row1=jnp.asarray(env['sam_row1']),
        env_light_id=jnp.asarray(np.int32(env['light_id'])),
        env_spec_id=jnp.asarray(np.int32(env['spec_id'])),
        env_spec_mult=jnp.asarray(np.float32(env['spec_mult'])),
        env_cam_back_id=jnp.asarray(np.int32(env['cam_back_id'])),
        proj_inv=jnp.asarray(proj_inv),
        world_view_inv=jnp.asarray(world_view_inv),
        cam_response_rgb=jnp.asarray(cam_response_rgb),
        cam_response_spec_id=jnp.asarray(np.array(cam_response_ids, np.int32)),
        textures=pool,
        cie_xyz=jnp.asarray(cie),
        mat_packed_f32=jnp.asarray(mat_pf),
        mat_packed_i32=jnp.asarray(mat_pi),
        light_packed_f32=jnp.asarray(lgt_pf),
        light_packed_i32=jnp.asarray(lgt_pi),
        mat_tex0_const=(jnp.asarray(mat_tex0_const) if tex0_all_const else None),
        two_level=two_level_obj,
        kn_nodes=None if kn_arrays is None else jnp.asarray(kn_arrays[0]),
        kn_tris=None if kn_arrays is None else jnp.asarray(kn_arrays[1]),
    )

    meta = SceneMeta(
        width=fb_w, height=fb_h, trace_depth=trace_depth, spp=spp,
        num_lights=len(lights), num_materials=M,
        spectral_mode=spectral_mode, has_motion=has_motion,
        has_env_map=env['tex_id'] >= 0, env_enable_sam=env['enable_sam'],
        has_cam_back=env['cam_back_id'] >= 0,
        has_spd_tex=has_spd_tex, spd_tex_max_sz=spd_tex_max_sz,
        use_two_level=use_two_level,
        use_kernel=use_kernel,
        cam_response_type=cam_response_type,
        has_cam_response_spectra=any(i >= 0 for i in cam_response_ids),
        has_blend=MAT_TYPE_BLEND in mat_types_present,
        has_ies=any(l['ies_id'] >= 0 for l in lights),
        has_proj=any((l['flags'] & LIGHT_FLAG_PROJECTIVE) and l['tex_id'] >= 0
                     for l in lights),
        has_spot=any(l['dist_type'] == LIGHT_DIST_SPOT for l in lights),
        max_blend_stack=4 if MAT_TYPE_BLEND in mat_types_present else 1,
        has_bump=any(m_.texid[1] != INVALID_ID for m_ in materials),
        has_four_textures=any(m_.cflags & FLAG_FOUR_TEXTURES for m_ in materials),
        tex0_all_const=tex0_all_const,
        num_tris=int(len(soup_v0)),
        use_bvh=use_bvh,
        cam_lens_radius=lens_radius, cam_target_dist=cam_target_dist,
        exposure_mult=exposure,
        mat_types_present=tuple(sorted(mat_types_present)),
        lens_lines=lens_lines, phys_size=phys_size,
    )
    return scene, meta
