"""Occupancy-map IO with ROS map_server semantics.

A copy of ``cilqr_tpu/utils/maps.py`` (NumPy only), kept equal to it by
``tests/test_torch_experiment.py``; the port imports nothing of the JAX
package.

Replaces the reference's map stack: the map_server YAML+image pairs
(``map_engine/maps/Town02.yaml``, ``h301.yaml``: image, resolution 0.2,
origin, negate, occupied_thresh 0.65, free_thresh 0.196) and the TGA->PNG
thresholding script (``map_engine/maps/convert.py:1-19``).

PNG decoding is implemented here directly (stdlib zlib + struct) so the
framework carries no imaging dependency; 8/16-bit gray and RGB(A) PNGs are
supported — enough for map_server-style maps.
"""

from __future__ import annotations

import dataclasses
import pathlib
import struct
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class MapInfo:
    image: str
    resolution: float
    origin: tuple  # (x, y, yaw) of the lower-left pixel
    negate: int = 0
    occupied_thresh: float = 0.65
    free_thresh: float = 0.196


def parse_map_yaml(path: str) -> MapInfo:
    """Minimal parser for map_server YAML (flat key: value lines)."""
    kv = {}
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.split("#")[0].strip()
        if not line or ":" not in line:
            continue
        k, v = line.split(":", 1)
        kv[k.strip()] = v.strip()
    origin = kv.get("origin", "[0, 0, 0]").strip("[]")
    origin = tuple(float(x) for x in origin.split(","))
    return MapInfo(
        image=kv["image"],
        resolution=float(kv["resolution"]),
        origin=origin,
        negate=int(kv.get("negate", 0)),
        occupied_thresh=float(kv.get("occupied_thresh", 0.65)),
        free_thresh=float(kv.get("free_thresh", 0.196)),
    )


def read_png(path: str) -> np.ndarray:
    """Decode a PNG into (H, W) grayscale uint8 (RGB averaged)."""
    data = pathlib.Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos = 8
    idat = b""
    width = height = bitdepth = ctype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctag = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctag == b"IHDR":
            width, height, bitdepth, ctype, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif ctag == b"IDAT":
            idat += chunk
        elif ctag == b"IEND":
            break
    raw = zlib.decompress(idat)

    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    if ctype == 3:
        raise ValueError("palette PNG unsupported")
    bpp_bits = channels * bitdepth
    stride = (width * bpp_bits + 7) // 8
    fbytes = max(1, bpp_bits // 8)

    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    off = 0
    for r in range(height):
        ftype = raw[off]
        line = np.frombuffer(raw[off + 1 : off + 1 + stride], np.uint8).astype(np.int32)
        off += 1 + stride
        cur = np.zeros(stride, np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            for i in range(stride):
                a = cur[i - fbytes] if i >= fbytes else 0
                b = prev[i]
                c = prev[i - fbytes] if i >= fbytes else 0
                if ftype == 1:
                    cur[i] = (line[i] + a) & 0xFF
                elif ftype == 3:
                    cur[i] = (line[i] + (a + b) // 2) & 0xFF
                elif ftype == 4:  # Paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    cur[i] = (line[i] + pred) & 0xFF
                else:
                    raise ValueError(f"bad filter {ftype}")
        out[r] = cur.astype(np.uint8)
        prev = cur

    if bitdepth == 16:
        px = out.view(">u2").reshape(height, width, channels)[..., :]
        px = (px >> 8).astype(np.uint8)
    elif bitdepth == 8:
        px = out.reshape(height, stride)[:, : width * channels].reshape(
            height, width, channels
        )
    else:
        raise ValueError(f"bitdepth {bitdepth} unsupported")

    if channels >= 3:
        gray = px[..., :3].mean(axis=-1).astype(np.uint8)
    elif channels == 2:
        gray = px[..., 0]
    else:
        gray = px[..., 0]
    return gray


def write_png(path: str, gray: np.ndarray) -> None:
    """Encode (H, W) uint8 grayscale as PNG (filter 0) — the convert.py
    equivalent output path."""
    gray = np.ascontiguousarray(gray, np.uint8)
    h, w = gray.shape
    raw = b"".join(b"\x00" + gray[r].tobytes() for r in range(h))

    def chunk(tag, payload):
        c = struct.pack(">I", len(payload)) + tag + payload
        return c + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    data = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )
    pathlib.Path(path).write_bytes(data)


def threshold_image(gray: np.ndarray, thresh: int = 150, low: int = 0, high: int = 254) -> np.ndarray:
    """convert.py:1-19 semantics: binary-threshold the scanned map so dark
    pixels become occupied (0) and light become free (254)."""
    return np.where(gray < thresh, low, high).astype(np.uint8)


def read_tga(path: str) -> np.ndarray:
    """Decode a TGA (the format the reference's CARLA map exports use,
    map_engine/maps/convert.py:4) into (H, W) grayscale uint8.

    Supports the types CARLA/PIL emit: uncompressed or RLE-compressed
    grayscale (3/11) and BGR(A) (2/10), bottom-up or top-down origin."""
    data = pathlib.Path(path).read_bytes()
    idlen, cmap_type, img_type = data[0], data[1], data[2]
    if cmap_type != 0:
        raise ValueError("color-mapped TGA unsupported")
    if img_type not in (2, 3, 10, 11):
        raise ValueError(f"TGA image type {img_type} unsupported")
    w, h = struct.unpack("<HH", data[12:16])
    bpp = data[16] // 8
    if bpp not in (1, 3, 4):
        raise ValueError(f"{8 * bpp}-bit TGA unsupported")
    top_down = bool(data[17] & 0x20)
    pos = 18 + idlen
    n = w * h
    if img_type in (2, 3):  # uncompressed
        px = np.frombuffer(data, np.uint8, n * bpp, pos).reshape(h, w, bpp)
    else:  # RLE
        out = np.empty((n, bpp), np.uint8)
        i = 0
        while i < n:
            hdr = data[pos]
            pos += 1
            count = (hdr & 0x7F) + 1
            if hdr & 0x80:  # run packet: one pixel repeated
                out[i : i + count] = np.frombuffer(data, np.uint8, bpp, pos)
                pos += bpp
            else:  # raw packet
                out[i : i + count] = np.frombuffer(
                    data, np.uint8, count * bpp, pos
                ).reshape(count, bpp)
                pos += count * bpp
            i += count
        px = out.reshape(h, w, bpp)
    if bpp == 1:
        gray = px[..., 0]
    else:  # TGA stores BGR(A); PIL's convert('L') weights are ITU-R 601
        b, g, r = (px[..., k].astype(np.float64) for k in range(3))
        gray = (0.299 * r + 0.587 * g + 0.114 * b).astype(np.uint8)
    return gray if top_down else gray[::-1]


def convert_tga_to_png(tga_path: str, png_path: str, threshold: int = 70) -> None:
    """The reference's map conversion script, faithfully
    (map_engine/maps/convert.py:1-19): grayscale, then pixels ABOVE the
    threshold become 0 (black) and the rest 255 — note the inversion."""
    gray = read_tga(tga_path)
    out = np.where(gray > threshold, 0, 255).astype(np.uint8)
    write_png(png_path, out)


def occupancy_from_image(gray: np.ndarray, info: MapInfo) -> np.ndarray:
    """map_server interpretation: p = (255 - v)/255 (or v/255 when negate),
    p > occupied_thresh -> 100, p < free_thresh -> 0, else -1 (unknown)."""
    v = gray.astype(np.float64) / 255.0
    p = v if info.negate else 1.0 - v
    occ = np.full(gray.shape, -1.0)
    occ[p > info.occupied_thresh] = 100.0
    occ[p < info.free_thresh] = 0.0
    return occ


def load_map(yaml_path: str):
    """(occupancy (H, W) in {-1, 0, 100}, MapInfo) from a map_server YAML.

    The occupancy row/col layout is image-native (row 0 = top scanline);
    ``to_gridmap_array`` reorients it into the framework's GridGeom
    convention (index (0,0) at the (+x, +y) corner).
    """
    info = parse_map_yaml(yaml_path)
    img = read_png(str(pathlib.Path(yaml_path).parent / info.image))
    return occupancy_from_image(img, info), info


def make_synthetic_town(
    out_dir: str,
    name: str = "town",
    size_m: float = 301.2,
    resolution: float = 0.2,
    origin=(-57.46, -356.56),
    lane_width: float = 10.0,
    seed: int = 0,
):
    """Generate a Town02-style occupancy map (PNG + map_server YAML).

    The reference ships CARLA's Town02 / real-site h301 maps as PNG+YAML
    assets (``map_engine/maps``; global geometry 301.2 x 301.2 m at 0.2 m
    centered (93.14, -205.96), local_costmap.cpp:119) — those are CARLA
    data, so this framework generates a synthetic stand-in with the same
    geometry: a rectangular road loop with free lanes (254), occupied
    buildings (0), and a ring road matching the ``long`` scenario legs
    (y = -306.74 and -105, x in [70, 195] in map coordinates).

    Returns the YAML path; load with ``load_map``.
    """
    n = int(round(size_m / resolution))
    img = np.zeros((n, n), np.uint8)  # occupied by default

    ox, oy = origin

    def to_px(x, y):
        # image row 0 = top scanline = max y
        col = (x - ox) / resolution
        row = n - 1 - (y - oy) / resolution
        return row, col

    def carve_lane(x0, y0, x1, y1):
        r0, c0 = to_px(min(x0, x1) - lane_width / 2, max(y0, y1) + lane_width / 2)
        r1, c1 = to_px(max(x0, x1) + lane_width / 2, min(y0, y1) - lane_width / 2)
        img[max(0, int(r0)) : min(n, int(r1) + 1),
            max(0, int(c0)) : min(n, int(c1) + 1)] = 254

    # ring road through the scenario legs (dataprocess.py obstacle tables)
    carve_lane(60.0, -306.74, 200.0, -306.74)   # south leg ("long"/"compare")
    carve_lane(60.0, -105.0, 200.0, -105.0)     # north leg
    carve_lane(60.0, -306.74, 60.0, -105.0)     # west leg
    carve_lane(191.0, -306.74, 191.0, -105.0)   # east leg (x~190 scenario 2/3)

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    png = out / f"{name}.png"
    write_png(str(png), img)
    yaml = out / f"{name}.yaml"
    yaml.write_text(
        f"image: {name}.png\nresolution: {resolution}\n"
        f"origin: [{ox}, {oy}, 0.0]\nnegate: 0\n"
        "occupied_thresh: 0.65\nfree_thresh: 0.196\n"
    )
    return str(yaml)


def make_synthetic_site(
    out_dir: str,
    name: str = "site",
    size_m: float = 120.0,
    resolution: float = 0.2,
    origin=(0.0, -60.0),
    corridor_width: float = 7.0,
    legs=None,
):
    """Generate an h301-class real-site occupancy map (PNG + YAML).

    The reference's second map is a scanned real site (``map_engine/maps/
    h301.yaml`` + ``convert.py``-thresholded image) whose corridors are NOT
    axis-aligned — the geometry class the rectangular synthetic town never
    exercises (every rotated-gather/propagation path then runs at yaw ~ 0).
    This generates the same class synthetically: diagonal corridor segments
    carved out of occupied space at arbitrary angles.

    ``legs``: [((x0, y0), (x1, y1)), ...] centerline segments in map
    coordinates; default is a dog-leg run at ~25 deg then ~-35 deg.  Returns
    (yaml_path, centerline (K, 2) ndarray) — the centerline doubles as the
    global plan for driving the site.
    """
    if legs is None:
        a = np.deg2rad(25.0)
        b = np.deg2rad(-35.0)
        p0 = np.array([10.0, -45.0])
        p1 = p0 + 55.0 * np.array([np.cos(a), np.sin(a)])
        p2 = p1 + 45.0 * np.array([np.cos(b), np.sin(b)])
        legs = [(tuple(p0), tuple(p1)), (tuple(p1), tuple(p2))]

    n = int(round(size_m / resolution))
    ox, oy = origin
    # pixel-center coordinates (image row 0 = top scanline = max y)
    xs = ox + (np.arange(n) + 0.5) * resolution          # cols
    ys = oy + (n - 0.5 - np.arange(n)) * resolution      # rows
    X = xs[None, :]
    Y = ys[:, None]

    free = np.zeros((n, n), bool)
    for (x0, y0), (x1, y1) in legs:
        dx, dy = x1 - x0, y1 - y0
        L2 = dx * dx + dy * dy
        t = np.clip(((X - x0) * dx + (Y - y0) * dy) / L2, 0.0, 1.0)
        d2 = (X - (x0 + t * dx)) ** 2 + (Y - (y0 + t * dy)) ** 2
        free |= d2 <= (corridor_width / 2.0) ** 2
    img = np.where(free, 254, 0).astype(np.uint8)

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    png = out / f"{name}.png"
    write_png(str(png), img)
    yaml = out / f"{name}.yaml"
    yaml.write_text(
        f"image: {name}.png\nresolution: {resolution}\n"
        f"origin: [{ox}, {oy}, 0.0]\nnegate: 0\n"
        "occupied_thresh: 0.65\nfree_thresh: 0.196\n"
    )
    pts = []
    for (x0, y0), (x1, y1) in legs:
        seg_len = float(np.hypot(x1 - x0, y1 - y0))
        k = max(2, int(seg_len))  # ~1 m spacing
        t = np.linspace(0.0, 1.0, k, endpoint=False)
        pts.append(np.stack([x0 + t * (x1 - x0), y0 + t * (y1 - y0)], axis=1))
    pts.append(np.asarray([legs[-1][1]]))
    return str(yaml), np.concatenate(pts, axis=0)


def to_gridmap_array(occ: np.ndarray, info: MapInfo, unknown_value: float = 0.0):
    """Reorient a map_server occupancy image into (data, center) for
    ``gridmap.make_geom``: grid_map axis 0 = +x (image cols, reversed),
    axis 1 = +y (image rows bottom-up, reversed)."""
    h, w = occ.shape
    # image: row 0 top (max y), col 0 left (min x); origin = lower-left cell
    data = np.where(occ < 0, unknown_value, occ)
    # -> (x, y) indexed ascending: transpose then flip x; y already descends
    # grid_map wants index 0 at MAX x and MAX y:
    arr = data.T[::-1, :]  # axis0: x descending; axis1: y descending (row0=top)
    cx = info.origin[0] + w * info.resolution / 2.0
    cy = info.origin[1] + h * info.resolution / 2.0
    return np.ascontiguousarray(arr), (cx, cy)
