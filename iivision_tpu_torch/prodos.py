"""ProDOS disk-image filesystem: create, read, and edit volumes natively.

The reference packages its player onto a bootable floppy with
AppleCommander.jar driven from a shell script (reference
player/make/createDiskImage:52-60, player/make/tail.mk:17) - a Java
dependency plus a binary template disk.  This module implements the ProDOS
filesystem itself (ProDOS 8 Technical Reference, chapter 4) so the same
packaging runs with zero external tools:

- create a fresh 140KB (or any size up to 32MB) ProDOS volume;
- read / add / delete / rename files (seedling, sapling and tree storage
  with sparse-block handling on read);
- load and emit both `.po` (ProDOS block order) and `.dsk` (DOS 3.3
  sector order) images, converting via the standard 15-s sector skew.

`make_disk.py` builds on this to reproduce the reference's apple2-loader
packaging flow (delete BASIC.SYSTEM, rename the loader, add the player
binary - createDiskImage's apple2-loader branch) against a user-supplied
template, or to create a self-contained volume from scratch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

BLOCK = 512
FLOPPY_BLOCKS = 280  # 140KB 5.25" floppy
VOLUME_DIR_BLOCKS = (2, 3, 4, 5)
BITMAP_BLOCK = 6
ENTRY_LENGTH = 0x27  # 39
ENTRIES_PER_BLOCK = 0x0D  # 13

# file types (ProDOS 8 TRM table B-1)
FILE_TYPES = {"txt": 0x04, "bin": 0x06, "dir": 0x0F, "bas": 0xFC,
              "var": 0xFD, "rel": 0xFE, "sys": 0xFF}
TYPE_NAMES = {v: k.upper() for k, v in FILE_TYPES.items()}

# seedling/sapling/tree: key block is data / index / master index
SEEDLING, SAPLING, TREE = 0x1, 0x2, 0x3

# DOS 3.3 logical sector holding ProDOS logical sector s of a track:
# both orders share the physical skew, so the permutation collapses to
# s -> 15-s (0 and 15 fixed); derived from Pdos^-1[Ppo[s]] with the
# standard software-skew tables.
_PO_TO_DO = [0, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 15]

# fixed timestamp so images are byte-reproducible (2026-01-01 00:00)
DEFAULT_DATE = ((2026 - 1900) << 9) | (1 << 5) | 1
DEFAULT_TIME = 0


class ProDOSError(Exception):
    pass


@dataclasses.dataclass
class FileEntry:
    name: str
    file_type: int
    aux_type: int
    storage_type: int
    key_pointer: int
    blocks_used: int
    eof: int
    access: int = 0xC3
    # location of the 39-byte entry: (block, byte offset)
    _loc: Optional[Tuple[int, int]] = None


def _swizzle(data: bytes, to_po: bool) -> bytes:
    """Reorder a 16-sector image between .dsk and .po track layouts."""
    if len(data) % (16 * 256):
        raise ProDOSError("image size %d is not a whole number of "
                          "16-sector tracks" % len(data))
    out = bytearray(len(data))
    n_tracks = len(data) // (16 * 256)
    for t in range(n_tracks):
        base = t * 16 * 256
        for s in range(16):
            src = base + _PO_TO_DO[s] * 256
            dst = base + s * 256
            if to_po:
                out[dst:dst + 256] = data[src:src + 256]
            else:
                out[src:src + 256] = data[dst:dst + 256]
    return bytes(out)


def dsk_to_po(data: bytes) -> bytes:
    return _swizzle(data, to_po=True)


def po_to_dsk(data: bytes) -> bytes:
    return _swizzle(data, to_po=False)


def _valid_name(name: str) -> str:
    name = name.upper()
    if not (1 <= len(name) <= 15):
        raise ProDOSError("name length must be 1..15: %r" % name)
    if not name[0].isalpha():
        raise ProDOSError("name must start with a letter: %r" % name)
    for c in name:
        if not (c.isalnum() or c == "."):
            raise ProDOSError("name may contain A-Z, 0-9, '.': %r" % name)
    return name


class ProDOSVolume:
    """An in-memory ProDOS volume over a flat block image."""

    def __init__(self, blocks: bytearray, total_blocks: int):
        self.data = blocks
        self.total_blocks = total_blocks

    # -- construction --------------------------------------------------------

    @classmethod
    def create(cls, volume_name: str = "IIVISION",
               total_blocks: int = FLOPPY_BLOCKS) -> "ProDOSVolume":
        if not (BITMAP_BLOCK < total_blocks <= 0xFFFF):
            raise ProDOSError("total_blocks out of range: %d" % total_blocks)
        name = _valid_name(volume_name)
        v = cls(bytearray(total_blocks * BLOCK), total_blocks)
        # volume directory: 4 linked blocks
        for i, b in enumerate(VOLUME_DIR_BLOCKS):
            prev = VOLUME_DIR_BLOCKS[i - 1] if i > 0 else 0
            nxt = VOLUME_DIR_BLOCKS[i + 1] \
                if i + 1 < len(VOLUME_DIR_BLOCKS) else 0
            v._w16(b * BLOCK, prev)
            v._w16(b * BLOCK + 2, nxt)
        # volume directory header (first entry of the key block)
        off = VOLUME_DIR_BLOCKS[0] * BLOCK + 4
        d = v.data
        d[off] = 0xF0 | len(name)
        d[off + 1:off + 16] = name.encode("ascii").ljust(15, b"\0")
        v._w16(off + 24, DEFAULT_DATE)
        v._w16(off + 26, DEFAULT_TIME)
        d[off + 28] = 0  # version
        d[off + 29] = 0  # min_version
        d[off + 30] = 0xC3  # access
        d[off + 31] = ENTRY_LENGTH
        d[off + 32] = ENTRIES_PER_BLOCK
        v._w16(off + 33, 0)  # file_count
        v._w16(off + 35, BITMAP_BLOCK)
        v._w16(off + 37, total_blocks)
        # bitmap: all free, then reserve boot + directory + bitmap blocks
        n_bitmap = (total_blocks + BLOCK * 8 - 1) // (BLOCK * 8)
        for blk in range(total_blocks):
            v._set_free(blk, True)
        for blk in (0, 1, *VOLUME_DIR_BLOCKS,
                    *range(BITMAP_BLOCK, BITMAP_BLOCK + n_bitmap)):
            v._set_free(blk, False)
        return v

    @classmethod
    def from_bytes(cls, data: bytes, order: str = "auto") -> "ProDOSVolume":
        """Load an image.  order: 'po', 'dsk', or 'auto' (try po, then
        dsk; a valid volume directory header disambiguates)."""
        if order == "auto":
            for o in ("po", "dsk"):
                try:
                    return cls.from_bytes(data, o)
                except ProDOSError:
                    continue
            raise ProDOSError("no ProDOS volume found in either order")
        raw = dsk_to_po(data) if order == "dsk" else bytes(data)
        if len(raw) % BLOCK:
            raise ProDOSError("image is not a whole number of 512B blocks")
        v = cls(bytearray(raw), len(raw) // BLOCK)
        hdr = v.data[2 * BLOCK + 4]
        if hdr >> 4 != 0xF or not (1 <= (hdr & 0xF) <= 15):
            raise ProDOSError("block 2 has no volume directory header")
        stored = v._r16(2 * BLOCK + 4 + 37)
        if not (BITMAP_BLOCK < stored <= v.total_blocks):
            raise ProDOSError("implausible total_blocks %d" % stored)
        v.total_blocks = stored
        return v

    # -- low-level helpers ---------------------------------------------------

    def _w16(self, off: int, val: int) -> None:
        self.data[off] = val & 0xFF
        self.data[off + 1] = (val >> 8) & 0xFF

    def _r16(self, off: int) -> int:
        return self.data[off] | (self.data[off + 1] << 8)

    def _bitmap_pos(self, blk: int) -> Tuple[int, int]:
        base = self._r16(2 * BLOCK + 4 + 35) * BLOCK
        return base + blk // 8, 7 - (blk % 8)

    def _is_free(self, blk: int) -> bool:
        off, bit = self._bitmap_pos(blk)
        return bool((self.data[off] >> bit) & 1)

    def _set_free(self, blk: int, free: bool) -> None:
        off, bit = self._bitmap_pos(blk)
        if free:
            self.data[off] |= (1 << bit)
        else:
            self.data[off] &= ~(1 << bit) & 0xFF

    def free_blocks(self) -> int:
        return sum(self._is_free(b) for b in range(self.total_blocks))

    def _alloc(self) -> int:
        for b in range(self.total_blocks):
            if self._is_free(b):
                self._set_free(b, False)
                return b
        raise ProDOSError("volume full")

    # -- directory -----------------------------------------------------------

    def _dir_entries(self):
        """Yield (block, offset) of every entry slot in the volume dir
        (excluding the header entry)."""
        blk = VOLUME_DIR_BLOCKS[0]
        first = True
        while blk:
            for i in range(ENTRIES_PER_BLOCK):
                off = blk * BLOCK + 4 + i * ENTRY_LENGTH
                if first and i == 0:
                    continue  # volume header
                yield blk, off
            first = False
            blk = self._r16(blk * BLOCK + 2)

    def _parse_entry(self, blk: int, off: int) -> Optional[FileEntry]:
        d = self.data
        st = d[off] >> 4
        nlen = d[off] & 0xF
        if st == 0 or nlen == 0:
            return None
        return FileEntry(
            name=d[off + 1:off + 1 + nlen].decode("ascii", "replace"),
            storage_type=st,
            file_type=d[off + 16],
            key_pointer=self._r16(off + 17),
            blocks_used=self._r16(off + 19),
            eof=d[off + 21] | (d[off + 22] << 8) | (d[off + 23] << 16),
            access=d[off + 30],
            aux_type=self._r16(off + 31),
            _loc=(blk, off))

    def list_files(self) -> List[FileEntry]:
        out = []
        for blk, off in self._dir_entries():
            e = self._parse_entry(blk, off)
            if e is not None:
                out.append(e)
        return out

    def _find(self, name: str) -> FileEntry:
        name = name.upper()
        for e in self.list_files():
            if e.name == name:
                return e
        raise ProDOSError("file not found: %s" % name)

    def _file_count_off(self) -> int:
        return VOLUME_DIR_BLOCKS[0] * BLOCK + 4 + 33

    # -- file data -----------------------------------------------------------

    def _data_blocks(self, e: FileEntry) -> List[int]:
        """Data block numbers in file order; 0 entries = sparse (zeros)."""
        if e.storage_type == SEEDLING:
            return [e.key_pointer]
        if e.storage_type == SAPLING:
            return self._index_blocks(e.key_pointer)
        if e.storage_type == TREE:
            out: List[int] = []
            for idx in self._index_blocks(e.key_pointer):
                out.extend(self._index_blocks(idx) if idx else [0] * 256)
            return out
        raise ProDOSError("unsupported storage type %d" % e.storage_type)

    def _index_blocks(self, idx_block: int) -> List[int]:
        base = idx_block * BLOCK
        return [self.data[base + i] | (self.data[base + 256 + i] << 8)
                for i in range(256)]

    def read_file(self, name: str) -> bytes:
        e = self._find(name)
        out = bytearray()
        for blk in self._data_blocks(e):
            if len(out) >= e.eof:
                break
            if blk == 0:  # sparse
                out += b"\0" * BLOCK
            else:
                out += self.data[blk * BLOCK:(blk + 1) * BLOCK]
        return bytes(out[:e.eof])

    def add_file(self, name: str, data: bytes, file_type: int = 0x06,
                 aux_type: int = 0) -> FileEntry:
        name = _valid_name(name)
        for e in self.list_files():
            if e.name == name:
                raise ProDOSError("file exists: %s" % name)
        # find a free directory slot
        slot = None
        for blk, off in self._dir_entries():
            if self._parse_entry(blk, off) is None:
                slot = (blk, off)
                break
        if slot is None:
            raise ProDOSError("volume directory full")

        n_data = max(1, (len(data) + BLOCK - 1) // BLOCK)
        if n_data > 256 * 256:
            raise ProDOSError("file too large for a tree file")
        blocks_used = 0
        data_blks: List[int] = []
        for i in range(n_data):
            b = self._alloc()
            chunk = data[i * BLOCK:(i + 1) * BLOCK]
            self.data[b * BLOCK:b * BLOCK + len(chunk)] = chunk
            self.data[b * BLOCK + len(chunk):(b + 1) * BLOCK] = \
                b"\0" * (BLOCK - len(chunk))
            data_blks.append(b)
            blocks_used += 1

        def write_index(pointers: List[int]) -> int:
            nonlocal blocks_used
            b = self._alloc()
            blocks_used += 1
            base = b * BLOCK
            self.data[base:base + BLOCK] = b"\0" * BLOCK
            for i, p in enumerate(pointers):
                self.data[base + i] = p & 0xFF
                self.data[base + 256 + i] = (p >> 8) & 0xFF
            return b

        if n_data == 1:
            storage, key = SEEDLING, data_blks[0]
        elif n_data <= 256:
            storage, key = SAPLING, write_index(data_blks)
        else:
            subs = [write_index(data_blks[i:i + 256])
                    for i in range(0, n_data, 256)]
            storage, key = TREE, write_index(subs)

        blk, off = slot
        d = self.data
        d[off] = (storage << 4) | len(name)
        d[off + 1:off + 16] = name.encode("ascii").ljust(15, b"\0")
        d[off + 16] = file_type
        self._w16(off + 17, key)
        self._w16(off + 19, blocks_used)
        d[off + 21] = len(data) & 0xFF
        d[off + 22] = (len(data) >> 8) & 0xFF
        d[off + 23] = (len(data) >> 16) & 0xFF
        self._w16(off + 24, DEFAULT_DATE)
        self._w16(off + 26, DEFAULT_TIME)
        d[off + 28] = 0
        d[off + 29] = 0
        d[off + 30] = 0xC3
        self._w16(off + 31, aux_type)
        self._w16(off + 33, DEFAULT_DATE)
        self._w16(off + 35, DEFAULT_TIME)
        # last 2 bytes of a file entry: header_pointer (dir key block)
        self._w16(off + 37, VOLUME_DIR_BLOCKS[0])
        self._w16(self._file_count_off(),
                  self._r16(self._file_count_off()) + 1)
        return self._parse_entry(blk, off)

    def delete_file(self, name: str) -> None:
        e = self._find(name)
        for blk in self._data_blocks(e):
            if blk:
                self._set_free(blk, True)
        if e.storage_type == SAPLING:
            self._set_free(e.key_pointer, True)
        elif e.storage_type == TREE:
            for idx in self._index_blocks(e.key_pointer):
                if idx:
                    self._set_free(idx, True)
            self._set_free(e.key_pointer, True)
        blk, off = e._loc
        self.data[off:off + ENTRY_LENGTH] = b"\0" * ENTRY_LENGTH
        self._w16(self._file_count_off(),
                  self._r16(self._file_count_off()) - 1)

    def rename_file(self, old: str, new: str) -> None:
        new = _valid_name(new)
        for e in self.list_files():
            if e.name == new:
                raise ProDOSError("file exists: %s" % new)
        e = self._find(old)
        blk, off = e._loc
        self.data[off] = (e.storage_type << 4) | len(new)
        self.data[off + 1:off + 16] = new.encode("ascii").ljust(15, b"\0")

    @property
    def volume_name(self) -> str:
        off = VOLUME_DIR_BLOCKS[0] * BLOCK + 4
        nlen = self.data[off] & 0xF
        return self.data[off + 1:off + 1 + nlen].decode("ascii", "replace")

    # -- serialization -------------------------------------------------------

    def to_po(self) -> bytes:
        return bytes(self.data)

    def to_dsk(self) -> bytes:
        if self.total_blocks != FLOPPY_BLOCKS:
            raise ProDOSError(".dsk order only applies to 140KB floppies")
        return po_to_dsk(bytes(self.data))
