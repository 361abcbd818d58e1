"""Image output: EXR (float) and LDR (BMP/PNG) with the reference's gamma.

Mirrors imageutils.cpp: ``SaveFrameBufferToEXR`` multiplies by normConst and
writes float scanlines; ``SaveLDRImageM`` applies ``pow(x*normConst, 1/gamma)``
(gamma 2.2 default) then quantizes.  The EXR writer is self-contained
(uncompressed scanline float32 OpenEXR 2.0) since no OpenEXR binding ships in
the environment; readable by OpenCV/tev/imageio.
"""
from __future__ import annotations

import struct

import numpy as np


def _exr_attr(name: str, type_name: str, data: bytes) -> bytes:
    return (name.encode() + b'\x00' + type_name.encode() + b'\x00'
            + struct.pack('<i', len(data)) + data)


def save_exr(path: str, img: np.ndarray, norm_const: float = 1.0):
    """Write [H, W, C(1|3|4)] or [H, W] float32 EXR, uncompressed."""
    img = np.asarray(img, np.float32) * np.float32(norm_const)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c == 4:
        img = img[..., :3]
        c = 3
    if c == 1:
        channel_names = ['Y']
        chan_src = {'Y': 0}
    elif c == 3:
        channel_names = ['B', 'G', 'R']  # alphabetical order
        chan_src = {'B': 2, 'G': 1, 'R': 0}
    else:
        # multi-channel spectral framebuffer (the reference's 3D spectral
        # EXR, imageutils.cpp SaveFrameBufferToEXR channels>4 path);
        # zero-padded names keep alphabetical == band order
        channel_names = [f's{i:03d}' for i in range(c)]
        chan_src = {n: i for i, n in enumerate(channel_names)}

    chlist = b''
    for name in channel_names:
        chlist += (name.encode() + b'\x00' + struct.pack('<i', 2)  # FLOAT
                   + struct.pack('<i', 0) + struct.pack('<ii', 1, 1))
    chlist += b'\x00'

    header = b''
    header += _exr_attr('channels', 'chlist', chlist)
    header += _exr_attr('compression', 'compression', b'\x00')  # none
    box = struct.pack('<iiii', 0, 0, w - 1, h - 1)
    header += _exr_attr('dataWindow', 'box2i', box)
    header += _exr_attr('displayWindow', 'box2i', box)
    header += _exr_attr('lineOrder', 'lineOrder', b'\x00')
    header += _exr_attr('pixelAspectRatio', 'float', struct.pack('<f', 1.0))
    header += _exr_attr('screenWindowCenter', 'v2f', struct.pack('<ff', 0, 0))
    header += _exr_attr('screenWindowWidth', 'float', struct.pack('<f', 1.0))
    header += b'\x00'

    magic = struct.pack('<i', 20000630) + struct.pack('<i', 2)
    offset_table_pos = len(magic) + len(header)
    table_size = h * 8
    data_start = offset_table_pos + table_size
    line_size = 8 + w * 4 * c
    offsets = b''.join(struct.pack('<Q', data_start + y * line_size)
                       for y in range(h))
    with open(path, 'wb') as f:
        f.write(magic)
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack('<ii', y, w * 4 * c))
            row = np.stack([img[y, :, chan_src[nm]] for nm in channel_names], 0)
            f.write(row.astype('<f4').tobytes())


def _exr_unzip(data: bytes, expected: int) -> bytes:
    """EXR ZIP/ZIPS block decode: inflate + delta-decode + de-interleave."""
    import zlib
    raw = bytearray(zlib.decompress(data))
    if len(raw) != expected:
        raise OSError(f'bad EXR zip block: {len(raw)} != {expected}')
    # delta decode: raw[i] = raw[i-1] + t[i] - 128 (mod 256)
    d = np.frombuffer(bytes(raw), np.uint8).astype(np.int64)
    d[1:] = d[1:] - 128
    d = np.cumsum(d) & 0xFF
    out = np.empty(len(d), np.uint8)
    half = (len(d) + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def load_exr(path: str) -> np.ndarray:
    """Minimal self-contained OpenEXR scanline reader.

    Supports single-part scanline files, NONE/ZIPS/ZIP compression,
    HALF/FLOAT channels. Returns [H, W, C] float32 with channels ordered
    (R, G, B[, A]) when present, else file order.
    """
    with open(path, 'rb') as f:
        data = f.read()
    if struct.unpack('<i', data[:4])[0] != 20000630:
        raise OSError(f'not an EXR file: {path}')
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b'\x00', pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b'\x00', pos)
        type_name = data[pos:e].decode()
        pos = e + 1
        size = struct.unpack('<i', data[pos:pos + 4])[0]
        pos += 4
        attrs[name] = (type_name, data[pos:pos + size])
        pos += size
    pos += 1  # header terminator

    # channels
    chdata = attrs['channels'][1]
    channels = []
    cp = 0
    while chdata[cp] != 0:
        e = chdata.index(b'\x00', cp)
        cname = chdata[cp:e].decode()
        cp = e + 1
        ptype = struct.unpack('<i', chdata[cp:cp + 4])[0]
        cp += 16
        channels.append((cname, ptype))  # 0=UINT,1=HALF,2=FLOAT
    compression = attrs['compression'][1][0]
    x0, y0, x1, y1 = struct.unpack('<iiii', attrs['dataWindow'][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    lines_per_block = {0: 1, 1: 1, 2: 1, 3: 16}.get(compression)
    if lines_per_block is None:
        raise OSError(f'unsupported EXR compression {compression}')
    n_blocks = -(-h // lines_per_block)
    offsets = struct.unpack(f'<{n_blocks}Q', data[pos:pos + 8 * n_blocks])

    dtype_of = {1: np.float16, 2: np.float32, 0: np.uint32}
    bpp_of = {1: 2, 2: 4, 0: 4}
    out = {c: np.zeros((h, w), np.float32) for c, _ in channels}
    for off in offsets:
        y, nbytes = struct.unpack('<ii', data[off:off + 8])
        block = data[off + 8:off + 8 + nbytes]
        ny = min(lines_per_block, y1 - y + 1)
        raw_size = ny * sum(w * bpp_of[pt] for _, pt in channels)
        if compression == 0 or nbytes == raw_size:
            raw = block
        else:
            raw = _exr_unzip(block, raw_size)
        bp = 0
        for line in range(ny):
            for cname, ptype in channels:  # per line: channels in list order
                n = w * bpp_of[ptype]
                vals = np.frombuffer(raw, dtype_of[ptype], count=w, offset=bp)
                out[cname][y - y0 + line] = vals.astype(np.float32)
                bp += n
    names = [c for c, _ in channels]
    if set('RGB').issubset(names):
        order = ['R', 'G', 'B'] + (['A'] if 'A' in names else [])
    else:
        order = names
    return np.stack([out[c] for c in order], axis=-1)


def imageio_v3():
    """The ``imageio`` package, imported on first use: only LDR image
    files (.png/.jpg/.bmp textures and outputs) need it."""
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError('reading or writing .png/.jpg/.bmp images needs '
                          'the imageio package') from e
    return iio


def save_ldr(path: str, img: np.ndarray, norm_const: float = 1.0,
             gamma: float = 2.2):
    """SaveLDRImageM (imageutils.cpp): x -> clamp(pow(x*norm, 1/gamma))*255."""
    iio = imageio_v3()
    data = np.asarray(img, np.float32) * np.float32(norm_const)
    if data.ndim == 3 and data.shape[2] == 4:
        data = data[..., :3]
    data = np.power(np.clip(data, 0.0, 1.0), 1.0 / gamma)
    u8 = np.clip(data * 255.0 + 0.5, 0, 255).astype(np.uint8)
    iio.imwrite(path, u8)


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 255.0) -> float:
    """OpenCV-style PSNR used by the reference harness (run_tests.py:60-65)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse <= 0:
        return 99.0
    return float(10.0 * np.log10(max_val * max_val / mse))
