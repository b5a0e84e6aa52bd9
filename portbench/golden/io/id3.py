"""ID3v2.3 tag writer.

Byte-level parity with the reference ID3TagWriter (MP3Encoder.swift:1034-1136):
- header "ID3" + version 2.3 + no flags + synchsafe size
- text frames TIT2/TPE1/TALB/TCON/TYER/TRCK with UTF-8 marker 0x03
- COMM with "eng" language + empty description
- APIC with front-cover picture type 0x03
- 10-byte frame headers with big-endian size and zero flags
- frame emission order: title, artist, album, genre, year, track, comment, art
"""

from __future__ import annotations

from ..options import ID3Tag


def _frame_header(frame_id: str, size: int) -> bytearray:
    out = bytearray(frame_id.encode("ascii"))
    out += size.to_bytes(4, "big")
    out += b"\x00\x00"  # no flags
    return out


def _text_frame(frame_id: str, value: str) -> bytes:
    payload = value.encode("utf-8")
    frame = _frame_header(frame_id, 1 + len(payload))
    frame.append(0x03)  # UTF-8 encoding marker
    frame += payload
    return bytes(frame)


def _comment_frame(comment: str) -> bytes:
    text = comment.encode("utf-8")
    frame = _frame_header("COMM", 1 + 3 + 1 + len(text))
    frame.append(0x03)
    frame += b"eng"
    frame.append(0x00)  # empty description
    frame += text
    return bytes(frame)


def _picture_frame(art: bytes, mime_type: str) -> bytes:
    mime = mime_type.encode("utf-8")
    frame = _frame_header("APIC", 1 + len(mime) + 1 + 1 + 1 + len(art))
    frame.append(0x03)
    frame += mime
    frame.append(0x00)  # MIME null terminator
    frame.append(0x03)  # picture type: front cover
    frame.append(0x00)  # empty description
    frame += art
    return bytes(frame)


def _synchsafe(size: int) -> bytes:
    return bytes(
        [(size >> 21) & 0x7F, (size >> 14) & 0x7F, (size >> 7) & 0x7F, size & 0x7F]
    )


def build_id3_tag(tag: ID3Tag) -> bytes:
    """Build a complete ID3v2.3 tag; empty bytes if no fields are set."""
    frames = bytearray()
    if tag.title is not None:
        frames += _text_frame("TIT2", tag.title)
    if tag.artist is not None:
        frames += _text_frame("TPE1", tag.artist)
    if tag.album is not None:
        frames += _text_frame("TALB", tag.album)
    if tag.genre is not None:
        frames += _text_frame("TCON", tag.genre)
    if tag.year is not None:
        frames += _text_frame("TYER", str(tag.year))
    if tag.track is not None:
        value = (
            f"{tag.track}/{tag.track_total}" if tag.track_total is not None else str(tag.track)
        )
        frames += _text_frame("TRCK", value)
    if tag.comment is not None:
        frames += _comment_frame(tag.comment)
    if tag.album_art is not None:
        frames += _picture_frame(tag.album_art, tag.album_art_mime_type)

    if not frames:
        return b""

    header = bytearray(b"ID3")
    header += b"\x03\x00"  # version 2.3
    header.append(0x00)  # flags
    header += _synchsafe(len(frames))
    return bytes(header + frames)
