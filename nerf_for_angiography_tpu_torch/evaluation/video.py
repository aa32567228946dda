"""Rotation-video export (visualization/helpers.py:47-70 equivalent; a
copy of ``nerf_for_angiography_tpu/evaluation/video.py``, which the port
does not import).

The reference writes mp4 via imageio+ffmpeg (helpers.py:47-49). Where
imageio with an ffmpeg backend is missing, the primary output is still a
real ``.mp4``: an ISO-BMFF (MP4) container with Motion-JPEG samples ('jpeg'
visual sample entry, the QTFF codec every mainstream demuxer maps to
MJPEG), frames JPEG-encoded by PIL, boxes written by hand with ``struct``
(``_mjpeg_mp4``). An animated GIF is written alongside for browser preview.
The MJPEG/AVI muxer (``_mjpeg_avi``) remains for players without
MJPEG-in-MP4 support. PIL is imported at the call, never at import.
"""

from __future__ import annotations

import struct

import numpy as np


def _jpeg_frames(frames_u8: list[np.ndarray], quality: int = 90) -> list[bytes]:
    import io

    from PIL import Image

    jpegs = []
    for f in frames_u8:
        img = Image.fromarray(f)
        if img.mode != "RGB":  # some decoders reject grayscale MJPEG
            img = img.convert("RGB")
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=quality)
        jpegs.append(buf.getvalue())
    return jpegs


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


def _mjpeg_mp4(frames_u8: list[np.ndarray], path: str, fps: int) -> None:
    """Mux JPEG-compressed frames into an ISO-BMFF .mp4 ('jpeg' sample
    entry = Motion JPEG). Layout: ftyp | mdat(all JPEGs) | moov. One chunk
    holds every sample (stsc), per-sample sizes in stsz, the single stco
    offset points at the first JPEG byte. Timescale: mvhd/tkhd 1000;
    media timescale = fps with per-sample delta 1."""
    jpegs = _jpeg_frames(frames_u8)
    h, w = frames_u8[0].shape[:2]
    n = len(jpegs)
    dur_ms = int(round(n * 1000 / fps))

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
    mdat = _box(b"mdat", b"".join(jpegs))
    mdat_payload_off = len(ftyp) + 8  # absolute offset of the first sample

    # --- stbl ---
    # 'jpeg' VisualSampleEntry: 6 reserved + dref idx, 16 pre_defined/rsvd,
    # w/h, 72dpi fixed-point resolutions, frame_count 1, 32-byte
    # compressorname, depth 24, pre_defined -1. No codec-specific box.
    sample_entry = _box(
        b"jpeg",
        b"\x00" * 6 + struct.pack(">H", 1)
        + b"\x00" * 16
        + struct.pack(">2H", w, h)
        + struct.pack(">2I", 0x00480000, 0x00480000)
        + struct.pack(">I", 0)
        + struct.pack(">H", 1)
        + b"\x00" * 32
        + struct.pack(">Hh", 24, -1),
    )
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1) + sample_entry)
    stts = _full(b"stts", 0, 0, struct.pack(">3I", 1, n, 1))
    stsc = _full(b"stsc", 0, 0, struct.pack(">4I", 1, 1, n, 1))
    stsz = _full(
        b"stsz", 0, 0,
        struct.pack(">2I", 0, n) + b"".join(struct.pack(">I", len(j)) for j in jpegs),
    )
    stco = _full(b"stco", 0, 0, struct.pack(">2I", 1, mdat_payload_off))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)

    # --- minf / mdia / trak ---
    vmhd = _full(b"vmhd", 0, 1, struct.pack(">4H", 0, 0, 0, 0))
    dref = _full(
        b"dref", 0, 0, struct.pack(">I", 1) + _full(b"url ", 0, 1, b"")
    )
    dinf = _box(b"dinf", dref)
    minf = _box(b"minf", vmhd + dinf + stbl)
    mdhd = _full(
        b"mdhd", 0, 0,
        struct.pack(">4I", 0, 0, fps, n) + struct.pack(">2H", 0x55C4, 0),  # 'und'
    )
    hdlr = _full(
        b"hdlr", 0, 0,
        struct.pack(">I", 0) + b"vide" + b"\x00" * 12 + b"MJPEG Video\x00",
    )
    mdia = _box(b"mdia", mdhd + hdlr + minf)

    identity = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    tkhd = _full(
        b"tkhd", 0, 3,  # enabled | in-movie
        struct.pack(">4I", 0, 0, 1, 0)  # times, track id 1, reserved
        + struct.pack(">I", dur_ms)
        + b"\x00" * 8
        + struct.pack(">4H", 0, 0, 0, 0)  # layer/group/volume/reserved
        + identity
        + struct.pack(">2I", w << 16, h << 16),
    )
    trak = _box(b"trak", tkhd + mdia)
    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">4I", 0, 0, 1000, dur_ms)
        + struct.pack(">I", 0x00010000)  # rate 1.0
        + struct.pack(">H", 0x0100)  # volume
        + b"\x00" * 10
        + identity
        + b"\x00" * 24
        + struct.pack(">I", 2),  # next track id
    )
    moov = _box(b"moov", mvhd + trak)

    with open(path, "wb") as f:
        f.write(ftyp + mdat + moov)


def _mjpeg_avi(frames_u8: list[np.ndarray], path: str, fps: int) -> None:
    """Mux JPEG-compressed frames into an AVI ('MJPG' fourcc).

    Minimal RIFF writer: hdrl(avih + one vids stream) + movi('00dc' chunks)
    + idx1. MJPEG is the one standard codec encodable with PIL alone.
    """
    jpegs = _jpeg_frames(frames_u8)
    h, w = frames_u8[0].shape[:2]
    n = len(jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(kind: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", kind + payload)

    max_sz = max(len(j) for j in jpegs)
    avih = struct.pack(
        "<14I", int(1e6 / fps), max_sz * fps, 0, 0x10,  # AVIF_HASINDEX
        n, 0, 1, max_sz, w, h, 0, 0, 0, 0,
    )
    strh = struct.pack(
        "<4s4sI2H8IH2hH",
        b"vids", b"MJPG", 0, 0, 0, 0, 1, fps, 0, n, max_sz,
        0xFFFFFFFF, 0, 0, 0, int(w), int(h),
    )
    strf = struct.pack("<I2i2H2I2i2I", 40, w, h, 1, 24, 0x47504A4D, w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_body = b"movi"
    idx = b""
    for j in jpegs:
        # idx1 offsets are relative to the start of the 'movi' fourcc
        idx += b"00dc" + struct.pack("<3I", 0x10, len(movi_body), len(j))
        movi_body += chunk(b"00dc", j)
    movi = chunk(b"LIST", movi_body)
    idx1 = chunk(b"idx1", idx)

    riff_body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body)


def save_video(frames, path: str, fps: int = 10, quality: int = 7) -> str | None:
    """Write a rotation animation; returns the path actually written.

    Tries the reference's imageio mp4 call (macro_block_size matching
    helpers.py:47-49); without an ffmpeg backend, writes ``path`` itself
    as an MJPEG-in-MP4 muxed by ``_mjpeg_mp4`` (format parity with the
    reference's .mp4 artifacts) AND a .gif alongside
    (browser-previewable), returning the .mp4 path.
    """
    frames = [np.asarray(f) for f in frames]
    if not frames:
        return None
    try:
        import imageio

        imageio.mimwrite(path, frames, fps=fps, quality=quality, macro_block_size=10)
        return path
    except Exception:
        pass
    written = None
    try:
        # the reference's actual artifact: a real .mp4 (MJPEG-in-BMFF,
        # muxed here — no ffmpeg in this image)
        _mjpeg_mp4(frames, path, fps)
        written = path
    except Exception as e:
        print(f"mp4 export skipped ({e})")
    try:
        from PIL import Image

        gif_path = path.rsplit(".", 1)[0] + ".gif"
        imgs = [Image.fromarray(f, mode="L" if f.ndim == 2 else None) for f in frames]
        imgs[0].save(
            gif_path,
            save_all=True,
            append_images=imgs[1:],
            duration=int(1000 / fps),
            loop=0,
        )
        written = written or gif_path
    except Exception as e:
        print(f"gif export skipped ({e})")
    if written is None:
        print("video export skipped (no writable backend)")
    return written


def get_videos(
    rows: list[dict], title: str, img_width: int, img_height: int, out_dir: str
) -> list[str]:
    """gt/pred/diff/binary rotation videos from sweep rows
    (helpers.py:51-70). ``rows`` are dicts holding org_img / pred_img /
    binary_pred_img flat images. Returns the list of files written."""
    to_u8 = lambda im: (255 * np.clip(im, 0, 1)).astype(np.uint8)  # noqa: E731
    gt, pred, diff, binp = [], [], [], []
    for row in rows:
        g = np.asarray(row["org_img"]).reshape(img_width, img_height)
        p = np.asarray(row["pred_img"]).reshape(img_width, img_height)
        b = np.asarray(row["binary_pred_img"]).reshape(img_width, img_height)
        gt.append(to_u8(g))
        pred.append(to_u8(p))
        diff.append(to_u8(np.abs(g - p)))
        binp.append(to_u8(b))
    written = [
        save_video(gt, f"{out_dir}/{title}-gt.mp4"),
        save_video(pred, f"{out_dir}/{title}-pred.mp4"),
        save_video(diff, f"{out_dir}/{title}-diff.mp4"),
        save_video(binp, f"{out_dir}/{title}-binary.mp4"),
    ]
    return [w for w in written if w]
