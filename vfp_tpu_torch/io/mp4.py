"""Box-level MP4 remuxing: parse / stream-copy concat / fMP4 fragmenting
(copied from ``vfp_tpu/io/mp4.py``; every function writes the same bytes).

The reference stream-copies its leak concat (``ffmpeg -c copy`` over an MP4
concat list, reference: tests/generate_leak.py:126-141) and fragments each
marked variant into a standalone ``.m4s`` (``-movflags
+frag_keyframe+empty_moov+default_base_moof``, reference: api/main.py:113-124).
The port spawns no ffmpeg binary, so this module does both as io/avi.py
does for AVI: pure box arithmetic, compressed sample bytes copied verbatim,
zero decode.

Scope: ISO BMFF progressive files (ftyp + mdat + moov with full sample
tables), such as cv2's mp4v writer, normal H.264 MP4s and the MJPEG-in-MP4
files ``write_mp4`` makes of ``track_from_mjpeg_avi`` tracks, and fragmented
ones (moof + trun, as ``fragment_mp4`` writes).  Handles multi-track (video
+ audio), 32/64-bit chunk offsets, stss sync tables and ctts composition
offsets.  Edit lists are dropped on rewrite (cv2/ffmpeg emit a zero-shift
elst for these files); the stsd sample-description box is copied verbatim so
codec private data (avcC/esds) survives untouched.

Samples are referenced lazily as (source path, offset, size) so concat of
multi-GB leaks streams without loading media into RAM.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

_CONTAINERS = {
    b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf",
    b"mvex", b"moof", b"traf",
}

# trun per-sample flags (ISO 14496-12 8.8.3): I-frame vs predicted
_SYNC_FLAGS = 0x02000000      # sample_depends_on = 2 (does not depend)
_NONSYNC_FLAGS = 0x01010000   # sample_depends_on = 1, non-sync bit


def _u32(b, off=0):
    return struct.unpack_from(">I", b, off)[0]


def _u64(b, off=0):
    return struct.unpack_from(">Q", b, off)[0]


def _box(typ: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), typ) + payload


def _full(typ: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(typ, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


def iter_boxes(data: bytes, off: int, end: int):
    """Yield (type, header_size, box_start, box_end) over a box sequence."""
    while off + 8 <= end:
        size, typ = struct.unpack_from(">I4s", data, off)
        hdr = 8
        if size == 1:
            size = _u64(data, off + 8)
            hdr = 16
        elif size == 0:
            size = end - off
        if size < hdr or off + size > end:
            raise IOError(f"malformed mp4 box {typ!r} at {off} (size {size})")
        yield typ, hdr, off, off + size
        off += size


def _find(data: bytes, off: int, end: int, typ: bytes):
    for t, hdr, s, e in iter_boxes(data, off, end):
        if t == typ:
            return hdr, s, e
    return None


@dataclass
class Sample:
    """One media sample — a lazy (src, offset, size) file reference, or
    inline bytes via ``data`` (src None) for samples sourced from non-MP4
    containers (e.g. AVI JPEG chunks)."""

    src: str | None
    offset: int
    size: int
    duration: int      # in track timescale ticks
    sync: bool = True
    cts: int = 0       # composition-time offset (signed)
    data: bytes | None = None


@dataclass
class Track:
    handler: bytes                 # b'vide' / b'soun' / ...
    timescale: int
    stsd: bytes                    # the full stsd box, verbatim
    samples: list = field(default_factory=list)
    width: float = 0.0             # tkhd presentation size (video)
    height: float = 0.0
    volume: int = 0                # tkhd volume (0x0100 for audio)
    language: int = 0x55C4         # mdhd packed language ('und')
    track_id: int = 0              # source file's tkhd id (traf matching)

    @property
    def duration(self) -> int:
        return sum(s.duration for s in self.samples)

    def codec_fourcc(self) -> bytes:
        # first sample entry's fourcc inside stsd
        return self.stsd[20:24] if len(self.stsd) >= 24 else b"????"


@dataclass
class Mp4File:
    tracks: list
    timescale: int = 1000

    def video(self):
        return next((t for t in self.tracks if t.handler == b"vide"), None)

    def audio(self):
        return next((t for t in self.tracks if t.handler == b"soun"), None)


def _parse_stbl(data, s, e, src, mdat_hint=None):
    """Expand the sample tables into a flat per-sample list."""
    boxes = {}
    for t, hdr, bs, be in iter_boxes(data, s, e):
        boxes[t] = (hdr, bs, be)

    def body(t):
        if t not in boxes:
            raise IOError(f"stbl missing required {t!r} box in {src}")
        hdr, bs, be = boxes[t]
        return bs + hdr + 4, be  # skip version/flags

    def table(t, p, e2, n, entry_bytes):
        # Foreign/corrupt files can carry absurd entry counts; validate
        # against the box end before expanding (a 0xFFFFFFFF count would
        # otherwise force a multi-GB list or a billion-iteration loop).
        if p + 4 + n * entry_bytes > e2:
            raise IOError(f"{t.decode()} table truncated in {src} "
                          f"({n} entries past box end)")

    # sizes
    p, e2 = body(b"stsz")
    fixed = _u32(data, p)
    count = _u32(data, p + 4)
    if count > len(data):  # every sample needs >=1 media byte somewhere
        raise IOError(f"implausible stsz sample count {count} in {src}")
    if fixed:
        sizes = [fixed] * count
    else:
        table(b"stsz", p + 4, e2, count, 4)
        sizes = list(struct.unpack_from(f">{count}I", data, p + 8))
    # durations (stts run-length)
    p, e2 = body(b"stts")
    n = _u32(data, p)
    table(b"stts", p, e2, n, 8)
    durations = []
    q = p + 4
    for _ in range(n):
        cnt, delta = struct.unpack_from(">II", data, q)
        # only `count` durations are consumed; cap the expansion so a huge
        # run-length can't blow memory
        durations.extend([delta] * min(cnt, count - len(durations)))
        q += 8
    # chunk offsets
    if b"stco" in boxes:
        p, e2 = body(b"stco")
        nc = _u32(data, p)
        table(b"stco", p, e2, nc, 4)
        chunk_offsets = list(struct.unpack_from(f">{nc}I", data, p + 4))
    else:
        p, e2 = body(b"co64")
        nc = _u32(data, p)
        table(b"co64", p, e2, nc, 8)
        chunk_offsets = list(struct.unpack_from(f">{nc}Q", data, p + 4))
    # samples-per-chunk (stsc)
    p, e2 = body(b"stsc")
    n = _u32(data, p)
    table(b"stsc", p, e2, n, 12)
    stsc = [struct.unpack_from(">III", data, p + 4 + 12 * i) for i in range(n)]
    # sync table
    syncs = None
    if b"stss" in boxes:
        p, e2 = body(b"stss")
        n = _u32(data, p)
        table(b"stss", p, e2, n, 4)
        syncs = set(struct.unpack_from(f">{n}I", data, p + 4))
    # composition offsets
    cts = [0] * count
    if b"ctts" in boxes:
        p, e2 = body(b"ctts")
        n = _u32(data, p)
        table(b"ctts", p, e2, n, 8)
        q = p + 4
        i = 0
        for _ in range(n):
            cnt = _u32(data, q)
            off = struct.unpack_from(">i", data, q + 4)[0]  # v1 signed; v0 fits
            for _ in range(min(cnt, count - i)):
                cts[i] = off
                i += 1
            q += 8

    samples = []
    si = 0
    for ci, coff in enumerate(chunk_offsets):
        # samples in this chunk per stsc (entries: first_chunk, per_chunk, id)
        per = 1
        for first, cnt, _id in stsc:
            if ci + 1 >= first:
                per = cnt
            else:
                break
        off = coff
        for _ in range(per):
            if si >= count:
                break
            samples.append(Sample(
                src=src, offset=off, size=sizes[si],
                duration=durations[si] if si < len(durations) else (durations[-1] if durations else 1),
                sync=(syncs is None or (si + 1) in syncs),
                cts=cts[si],
            ))
            off += sizes[si]
            si += 1
    if si != count:
        raise IOError(f"mp4 sample tables inconsistent: placed {si} of {count}")
    return samples


def _parse_fragments(data: bytes, path: str, tracks_by_id: dict):
    """Append moof/traf/trun samples to ``tracks_by_id`` (fMP4 input)."""
    for t, hdr, s, e in iter_boxes(data, 0, len(data)):
        if t != b"moof":
            continue
        moof_start = s
        for t2, h2, s2, e2 in iter_boxes(data, s + hdr, e):
            if t2 != b"traf":
                continue
            track = None
            base_offset = moof_start  # default-base-is-moof
            d_dur = d_size = d_flags = 0
            run_end = None  # running offset across truns (ISO 14496-12 8.8.8)
            for t3, h3, s3, e3 in iter_boxes(data, s2 + h2, e2):
                p = s3 + h3
                if t3 == b"tfhd":
                    flags = int.from_bytes(data[p + 1: p + 4], "big")
                    track_id = _u32(data, p + 4)
                    track = tracks_by_id.get(track_id)
                    q = p + 8
                    if flags & 0x000001:  # base-data-offset
                        base_offset = _u64(data, q)
                        q += 8
                    if flags & 0x000002:  # sample-description-index
                        q += 4
                    if flags & 0x000008:
                        d_dur = _u32(data, q)
                        q += 4
                    if flags & 0x000010:
                        d_size = _u32(data, q)
                        q += 4
                    if flags & 0x000020:
                        d_flags = _u32(data, q)
                elif t3 == b"trun" and track is not None:
                    flags = int.from_bytes(data[p + 1: p + 4], "big")
                    n = _u32(data, p + 4)
                    q = p + 8
                    # per-sample table bytes must fit inside the trun box;
                    # with no per-sample fields (flags 0x100..0x800 clear)
                    # nothing bounds n, so cap it at a count no real
                    # fragment approaches (one trun covers ~seconds)
                    bpp = 4 * sum(1 for f in (0x100, 0x200, 0x400, 0x800)
                                  if flags & f)
                    hdr_extra = (4 if flags & 0x1 else 0) + \
                        (4 if flags & 0x4 else 0)
                    if bpp and q + hdr_extra + n * bpp > e3:
                        raise IOError(f"trun table truncated in {path} "
                                      f"({n} samples past box end)")
                    if n > max(len(data), 1 << 24):
                        raise IOError(
                            f"implausible trun sample count {n} in {path}")
                    if flags & 0x000001:
                        off = base_offset + struct.unpack_from(">i", data, q)[0]
                        q += 4
                    elif run_end is not None:
                        # no data-offset: this run continues where the
                        # previous trun's bytes ended
                        off = run_end
                    else:
                        off = base_offset
                    first_flags = None
                    if flags & 0x000004:
                        first_flags = _u32(data, q)
                        q += 4
                    for i in range(n):
                        dur, size, sflags, cts = d_dur, d_size, d_flags, 0
                        if flags & 0x000100:
                            dur = _u32(data, q)
                            q += 4
                        if flags & 0x000200:
                            size = _u32(data, q)
                            q += 4
                        if flags & 0x000400:
                            sflags = _u32(data, q)
                            q += 4
                        if flags & 0x000800:
                            cts = struct.unpack_from(">i", data, q)[0]
                            q += 4
                        if i == 0 and first_flags is not None:
                            sflags = first_flags
                        track.samples.append(Sample(
                            src=path, offset=off, size=size, duration=dur,
                            sync=not (sflags & 0x00010000), cts=cts))
                        off += size
                    run_end = off


def read_mp4(path) -> Mp4File:
    """Parse an MP4's sample tables — progressive (stbl) or fragmented
    (moof/trun) — leaving media bytes on disk.  The file is mapped read-only
    (mmap), so only the box-table pages actually touched are paged in; a
    multi-GB mdat never enters RAM."""
    import mmap

    path = str(path)
    with open(path, "rb") as f:
        try:
            data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # zero-length / unmappable file
            data = f.read()
        try:
            return _read_mp4_buf(data, path)
        finally:
            if isinstance(data, mmap.mmap):
                data.close()


def _read_mp4_buf(data, path: str) -> Mp4File:
    # Parse errors on foreign/corrupt files must surface as IOError, not
    # leak struct.error/IndexError from whatever field happened to fall off
    # the end of the buffer.
    try:
        return _read_mp4_buf_inner(data, path)
    except (struct.error, IndexError, KeyError, OverflowError) as exc:
        raise IOError(f"malformed mp4 {path}: {exc}") from exc


def _read_mp4_buf_inner(data, path: str) -> Mp4File:
    moov = _find(data, 0, len(data), b"moov")
    if moov is None:
        raise IOError(f"no moov box in {path} (truncated?)")
    hdr, ms, me = moov
    timescale = 1000
    tracks = []
    for t, thdr, ts, te in iter_boxes(data, ms + hdr, me):
        if t == b"mvhd":
            v = data[ts + thdr]
            timescale = _u32(data, ts + thdr + (20 if v else 12))
        if t != b"trak":
            continue
        width = height = 0.0
        tk_timescale, language = 1000, 0x55C4
        handler = b"????"
        stsd = b""
        samples = []
        track_id = len(tracks) + 1
        tkhd = _find(data, ts + thdr, te, b"tkhd")
        if tkhd:
            khdr, ks, ke = tkhd
            v = data[ks + khdr]
            track_id = _u32(data, ks + khdr + 4 + (16 if v else 8))
            base = ks + khdr + 4 + (32 if v else 20)
            # reserved(8) layer(2) alt(2) volume(2) rsvd(2) matrix(36) w(4) h(4)
            width = _u32(data, base + 52) / 65536.0
            height = _u32(data, base + 56) / 65536.0
        mdia = _find(data, ts + thdr, te, b"mdia")
        if not mdia:
            continue
        mhdr, mms, mme = mdia
        for t2, h2, s2, e2 in iter_boxes(data, mms + mhdr, mme):
            if t2 == b"mdhd":
                v = data[s2 + h2]
                if v:
                    tk_timescale = _u32(data, s2 + h2 + 20)
                    language = struct.unpack_from(">H", data, s2 + h2 + 32)[0]
                else:
                    tk_timescale = _u32(data, s2 + h2 + 12)
                    language = struct.unpack_from(">H", data, s2 + h2 + 20)[0]
            elif t2 == b"hdlr":
                handler = data[s2 + h2 + 8: s2 + h2 + 12]
            elif t2 == b"minf":
                stbl = _find(data, s2 + h2, e2, b"stbl")
                if stbl:
                    bhdr, bs, be = stbl
                    sd = _find(data, bs + bhdr, be, b"stsd")
                    if sd:
                        stsd = data[sd[1]: sd[2]]
                    samples = _parse_stbl(data, bs + bhdr, be, path)
        tr = Track(handler=handler, timescale=tk_timescale, stsd=stsd,
                   samples=samples, width=width, height=height,
                   language=language, track_id=track_id,
                   volume=0x0100 if handler == b"soun" else 0)
        tracks.append(tr)
    if not any(t.samples for t in tracks):
        # fragmented file (empty_moov): samples live in moof/trun boxes
        _parse_fragments(data, path, {t.track_id: t for t in tracks})
    return Mp4File(tracks=tracks, timescale=timescale)


def _rle(values):
    out = []
    for v in values:
        if out and out[-1][1] == v:
            out[-1][0] += 1
        else:
            out.append([1, v])
    return out


def _mvhd(timescale: int, duration: int, next_track: int) -> bytes:
    return _full(b"mvhd", 0, 0, struct.pack(
        ">IIII", 0, 0, timescale, duration)
        + struct.pack(">i", 0x00010000) + struct.pack(">h", 0x0100)
        + b"\x00" * 10
        + struct.pack(">9i", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000)
        + b"\x00" * 24 + struct.pack(">I", next_track))


def _tkhd(track_id: int, duration: int, tr: Track) -> bytes:
    return _full(b"tkhd", 0, 7, struct.pack(
        ">IIIII", 0, 0, track_id, 0, duration)
        + b"\x00" * 8 + struct.pack(">hhhh", 0, 0, tr.volume, 0)
        + struct.pack(">9i", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000)
        + struct.pack(">II", int(tr.width * 65536), int(tr.height * 65536)))


def _mdhd(tr: Track, duration: int) -> bytes:
    return _full(b"mdhd", 0, 0, struct.pack(
        ">IIIIHH", 0, 0, tr.timescale, duration, tr.language, 0))


def _hdlr(handler: bytes) -> bytes:
    name = {b"vide": b"VideoHandler\x00", b"soun": b"SoundHandler\x00"}.get(
        handler, b"Handler\x00")
    return _full(b"hdlr", 0, 0, b"\x00" * 4 + handler + b"\x00" * 12 + name)


def _media_header(handler: bytes) -> bytes:
    if handler == b"soun":
        return _full(b"smhd", 0, 0, struct.pack(">hh", 0, 0))
    if handler == b"vide":
        return _full(b"vmhd", 0, 1, struct.pack(">hhhh", 0, 0, 0, 0))
    return _full(b"nmhd", 0, 0, b"")


def _dinf() -> bytes:
    return _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1)
                               + _full(b"url ", 0, 1, b"")))


def _stbl_boxes(tr: Track, chunk_offsets, chunk_runs, co64: bool) -> bytes:
    """Full sample tables for the given chunking.

    ``chunk_runs`` is [(samples_in_chunk), ...] aligned with chunk_offsets."""
    stts = b"".join(struct.pack(">II", c, v)
                    for c, v in _rle([s.duration for s in tr.samples]))
    stts = _full(b"stts", 0, 0,
                 struct.pack(">I", len(_rle([s.duration for s in tr.samples]))) + stts)
    # stsc from chunk_runs (first_chunk, samples_per_chunk, sample_desc=1)
    entries = []
    for i, cnt in enumerate(chunk_runs):
        if not entries or entries[-1][1] != cnt:
            entries.append((i + 1, cnt))
    stsc = _full(b"stsc", 0, 0, struct.pack(">I", len(entries)) + b"".join(
        struct.pack(">III", first, cnt, 1) for first, cnt in entries))
    sizes = [s.size for s in tr.samples]
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, len(sizes))
                 + struct.pack(f">{len(sizes)}I", *sizes))
    if co64:
        stco = _full(b"co64", 0, 0, struct.pack(">I", len(chunk_offsets))
                     + struct.pack(f">{len(chunk_offsets)}Q", *chunk_offsets))
    else:
        stco = _full(b"stco", 0, 0, struct.pack(">I", len(chunk_offsets))
                     + struct.pack(f">{len(chunk_offsets)}I", *chunk_offsets))
    out = tr.stsd + stts + stsc + stsz + stco
    if not all(s.sync for s in tr.samples):
        idx = [i + 1 for i, s in enumerate(tr.samples) if s.sync]
        out += _full(b"stss", 0, 0, struct.pack(">I", len(idx))
                     + struct.pack(f">{len(idx)}I", *idx))
    if any(s.cts for s in tr.samples):
        runs = _rle([s.cts for s in tr.samples])
        out += _full(b"ctts", 1, 0, struct.pack(">I", len(runs)) + b"".join(
            struct.pack(">Ii", c, v) for c, v in runs))
    return _box(b"stbl", out)


def _interleave(tracks, chunk_ticks: float = 1.0):
    """Order (track_index, [samples]) chunks by decode time, ~1s groups."""
    cursors = [0] * len(tracks)
    times = [0.0] * len(tracks)
    order = []
    while True:
        live = [i for i in range(len(tracks)) if cursors[i] < len(tracks[i].samples)]
        if not live:
            break
        i = min(live, key=lambda k: times[k])
        tr = tracks[i]
        start = cursors[i]
        t_end = times[i] + chunk_ticks
        while cursors[i] < len(tr.samples) and times[i] < t_end:
            times[i] += tr.samples[cursors[i]].duration / max(tr.timescale, 1)
            cursors[i] += 1
        order.append((i, start, cursors[i]))
    return order


FTYP = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")

# largest mdat (header included) representable with a u32 size field; tests
# shrink this to drive the 64-bit largesize path without a real 4GiB file
_MDAT_U32_MAX = 0xFFFFFFFF


def write_mp4(path, tracks, timescale: int = 1000):
    """Write a progressive MP4 (ftyp + mdat + moov), streaming sample bytes
    from their source files.  Track order is preserved; samples are
    interleaved in ~1-second chunks for playability."""
    path = Path(path)
    order = _interleave(tracks)
    handles: dict = {}

    def src_handle(name):
        if name not in handles:
            handles[name] = open(name, "rb")
        return handles[name]

    # mdat payload size is known upfront from the sample tables; pick a
    # 64-bit largesize header when 8 + payload would overflow the u32 size
    # field (a >4GiB concat would otherwise fail after writing all media)
    payload_total = sum(s.size for tr in tracks for s in tr.samples)
    big_mdat = 8 + payload_total > _MDAT_U32_MAX
    try:
        with open(path, "wb") as out:
            out.write(FTYP)
            mdat_header_pos = out.tell()
            if big_mdat:
                out.write(struct.pack(">I4sQ", 1, b"mdat", 0))
            else:
                out.write(struct.pack(">I4s", 0, b"mdat"))
            chunk_offsets = [[] for _ in tracks]
            chunk_runs = [[] for _ in tracks]
            for ti, lo, hi in order:
                chunk_offsets[ti].append(out.tell())
                chunk_runs[ti].append(hi - lo)
                for s in tracks[ti].samples[lo:hi]:
                    if s.data is not None:
                        out.write(s.data)
                        continue
                    f = src_handle(s.src)
                    f.seek(s.offset)
                    remaining = s.size
                    while remaining:
                        b = f.read(min(remaining, 1 << 20))
                        if not b:
                            raise IOError(f"truncated sample in {s.src}")
                        out.write(b)
                        remaining -= len(b)
            mdat_end = out.tell()
            out.seek(mdat_header_pos)
            if big_mdat:
                out.write(struct.pack(">I4sQ", 1, b"mdat",
                                      mdat_end - mdat_header_pos))
            else:
                out.write(struct.pack(">I", mdat_end - mdat_header_pos))
            out.seek(mdat_end)

            co64 = mdat_end > _MDAT_U32_MAX - 15
            traks = b""
            max_dur = 0
            for ti, tr in enumerate(tracks):
                dur_movie = int(round(tr.duration * timescale / max(tr.timescale, 1)))
                max_dur = max(max_dur, dur_movie)
                minf = _media_header(tr.handler) + _dinf() + _stbl_boxes(
                    tr, chunk_offsets[ti], chunk_runs[ti], co64)
                mdia = _mdhd(tr, tr.duration) + _hdlr(tr.handler) + _box(b"minf", minf)
                traks += _box(b"trak", _tkhd(ti + 1, dur_movie, tr) + _box(b"mdia", mdia))
            out.write(_box(b"moov", _mvhd(timescale, max_dur, len(tracks) + 1) + traks))
    finally:
        for f in handles.values():
            f.close()
    return path


def concat_mp4(inputs, output) -> Path:
    """Bitwise stream-copy concat: sample bytes from every input are copied
    verbatim, sample tables are rebuilt (the reference's ``-c copy`` concat,
    tests/generate_leak.py:126-141).  Inputs must share per-track codecs
    (same stsd fourcc, matching track layout by handler)."""
    parsed = [read_mp4(p) for p in inputs]
    base = parsed[0]
    out_tracks = []
    for tr in base.tracks:
        merged = Track(handler=tr.handler, timescale=tr.timescale,
                       stsd=tr.stsd, width=tr.width, height=tr.height,
                       volume=tr.volume, language=tr.language)
        out_tracks.append(merged)
    for fi, f in enumerate(parsed):
        by_handler = {t.handler: t for t in f.tracks}
        for merged in out_tracks:
            tr = by_handler.get(merged.handler)
            if tr is None:
                continue  # e.g. an audio-less segment in the middle
            if tr.stsd[20:24] != merged.stsd[20:24]:
                raise IOError(
                    f"concat codec mismatch in {inputs[fi]}: "
                    f"{tr.stsd[20:24]!r} vs {merged.stsd[20:24]!r}")
            if tr.timescale == merged.timescale:
                merged.samples.extend(tr.samples)
            else:
                scale = merged.timescale / tr.timescale
                for s in tr.samples:
                    merged.samples.append(Sample(
                        s.src, s.offset, s.size,
                        max(1, int(round(s.duration * scale))),
                        s.sync, int(round(s.cts * scale))))
    return write_mp4(output, out_tracks)


def _trex(track_id: int) -> bytes:
    return _full(b"trex", 0, 0, struct.pack(">IIIII", track_id, 1, 0, 0, 0))


def audio_sidecar(media_path) -> Path:
    """Per-segment audio sidecar path: ``segment_000.avi`` ->
    ``segment_000.audio.mp4``.  Segments and variants are ``.rawv`` or MJPEG
    ``.avi`` files, which carry no audio, so the segmenter stream-copies each
    segment's audio slice into this sidecar and the splice/download paths
    mux it back."""
    p = Path(media_path)
    return p.with_name(p.stem + ".audio.mp4")


def fragment_mp4(input_path, output, brand: bytes = b"iso5",
                 extra_tracks=()) -> Path:
    """Rewrite a progressive MP4 as a standalone single-fragment fMP4
    (``ftyp + moov(empty stbl, mvex) + moof + mdat``) — the shape ffmpeg's
    ``-movflags +frag_keyframe+empty_moov+default_base_moof`` produces for
    one segment (reference: api/main.py:113-124).  The output is fully
    self-initializing: playable on its own and listable directly in an HLS
    media playlist, which is how the reference's per-viewer playlists mix
    variants with zero per-view work."""
    src = read_mp4(input_path)
    tracks = [t for t in src.tracks if t.samples] + [
        t for t in extra_tracks if t.samples]
    ftyp = _box(b"ftyp", brand + struct.pack(">I", 512) + b"iso5iso6mp41")

    # empty_moov: zero-duration movie, empty sample tables, mvex/trex
    traks = b""
    for ti, tr in enumerate(tracks):
        empty_stbl = _box(b"stbl", tr.stsd
                          + _full(b"stts", 0, 0, struct.pack(">I", 0))
                          + _full(b"stsc", 0, 0, struct.pack(">I", 0))
                          + _full(b"stsz", 0, 0, struct.pack(">II", 0, 0))
                          + _full(b"stco", 0, 0, struct.pack(">I", 0)))
        minf = _media_header(tr.handler) + _dinf() + empty_stbl
        mdia = _mdhd(tr, 0) + _hdlr(tr.handler) + _box(b"minf", minf)
        traks += _box(b"trak", _tkhd(ti + 1, 0, tr) + _box(b"mdia", mdia))
    mvex = _box(b"mvex", b"".join(_trex(ti + 1) for ti in range(len(tracks))))
    moov = _box(b"moov", _mvhd(src.timescale, 0, len(tracks) + 1) + traks + mvex)

    # one moof with a traf per track; mdat carries track runs back to back
    mdat_payload_sizes = [sum(s.size for s in tr.samples) for tr in tracks]
    # build trafs twice: once to learn the moof size, once with real offsets
    def build_trafs(moof_size: int):
        out = b""
        data_off = moof_size + 8  # into mdat payload
        run_base = 0
        for ti, tr in enumerate(tracks):
            tfhd = _full(b"tfhd", 0, 0x020000, struct.pack(">I", ti + 1))
            tfdt = _full(b"tfdt", 1, 0, struct.pack(">Q", 0))
            flags = 0x000001 | 0x000100 | 0x000200 | 0x000400
            has_cts = any(s.cts for s in tr.samples)
            if has_cts:
                flags |= 0x000800
            rows = b""
            for s in tr.samples:
                rows += struct.pack(">III", s.duration, s.size,
                                    _SYNC_FLAGS if s.sync else _NONSYNC_FLAGS)
                if has_cts:
                    rows += struct.pack(">i", s.cts)
            trun = _full(b"trun", 1, flags,
                         struct.pack(">Ii", len(tr.samples),
                                     data_off + run_base) + rows)
            out += _box(b"traf", tfhd + tfdt + trun)
            run_base += mdat_payload_sizes[ti]
        return out

    mfhd = _full(b"mfhd", 0, 0, struct.pack(">I", 1))
    probe = _box(b"moof", mfhd + build_trafs(0))
    moof = _box(b"moof", mfhd + build_trafs(len(probe)))
    assert len(moof) == len(probe)

    output = Path(output)
    with open(output, "wb") as out:
        out.write(ftyp + moov + moof)
        out.write(struct.pack(">I4s", 8 + sum(mdat_payload_sizes), b"mdat"))
        handles: dict = {}
        try:
            for tr in tracks:
                for s in tr.samples:
                    if s.data is not None:
                        out.write(s.data)
                        continue
                    f = handles.get(s.src)
                    if f is None:
                        f = handles[s.src] = open(s.src, "rb")
                    f.seek(s.offset)
                    out.write(f.read(s.size))
        finally:
            for f in handles.values():
                f.close()
    return output


def _jpeg_stsd(width: int, height: int) -> bytes:
    """stsd with a plain 'jpeg' VisualSampleEntry (MJPEG-in-MP4)."""
    entry = (struct.pack(">I4s", 86, b"jpeg")
             + b"\x00" * 6 + struct.pack(">H", 1)      # data_reference_index
             + b"\x00" * 16
             + struct.pack(">HH", width, height)
             + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
             + b"\x00" * 4 + struct.pack(">H", 1)      # frame_count
             + b"\x00" * 32                             # compressorname
             + struct.pack(">Hh", 24, -1))              # depth, pre_defined
    return _full(b"stsd", 0, 0, struct.pack(">I", 1) + entry)


def track_from_mjpeg_avi(path, timescale: int = 600) -> Track:
    """Stream-copy an MJPEG-AVI's video stream into an MP4 video track:
    every AVI '00dc' JPEG chunk becomes one all-sync sample (io/avi.py does
    the RIFF walk).  This is what lets the no-ffmpeg AVI marking chain emit
    standard .mp4 leaks/downloads that still carry audio — no decode."""
    from .avi import avi_meta, iter_video_chunk_spans

    meta = avi_meta(path)
    if not meta["mjpeg"]:
        raise IOError(f"{path} is not MJPEG; chunk copy would not decode")
    fps = meta["fps"] or 30.0
    dur = max(1, int(round(timescale / fps)))
    tr = Track(handler=b"vide", timescale=timescale,
               stsd=_jpeg_stsd(meta["width"], meta["height"]),
               width=float(meta["width"]), height=float(meta["height"]))
    path = str(path)
    for off, size in iter_video_chunk_spans(path):
        tr.samples.append(Sample(src=path, offset=off, size=size, duration=dur))
    return tr


def slice_track_by_time(tr: Track, t0: float, t1: float) -> Track:
    """Samples of ``tr`` whose decode time lies in [t0, t1) seconds — used to
    carry audio alongside re-encoded video segments (audio samples are all
    sync, so a time slice is always decodable)."""
    out = Track(handler=tr.handler, timescale=tr.timescale, stsd=tr.stsd,
                width=tr.width, height=tr.height, volume=tr.volume,
                language=tr.language)
    t = 0.0
    for s in tr.samples:
        if t0 <= t < t1:
            out.samples.append(s)
        t += s.duration / max(tr.timescale, 1)
        if t >= t1:
            break
    return out


def add_audio_track(video_mp4, audio_track: Track, output=None) -> Path:
    """Remux ``audio_track``'s samples into ``video_mp4`` (stream copy of
    both).  In-place when ``output`` is None (write-then-replace)."""
    video_mp4 = Path(video_mp4)
    src = read_mp4(video_mp4)
    tracks = [t for t in src.tracks if t.handler == b"vide"] + [audio_track]
    if output is None:
        tmp = video_mp4.with_suffix(video_mp4.suffix + ".tmp")
        write_mp4(tmp, tracks, timescale=src.timescale)
        tmp.replace(video_mp4)
        return video_mp4
    return write_mp4(output, tracks, timescale=src.timescale)
