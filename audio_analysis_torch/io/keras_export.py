"""Write tuned weights back into a ``.keras`` archive without h5py (the JAX
package's io/keras_export.py).

The source archive is copied member by member, so everything not
understood here (metadata.json, the compile config, the attribute layout)
stays byte for byte; only ``model.weights.h5`` changes, and ``config.json``
when a new config is given (a replaced head changes a Dense's ``units``).
The HDF5 file is edited in place, in the formats io/h5read.py reads:

- a variable of the same shape is overwritten at its data's offset;
- a variable whose shape changed (a replaced head) gets its data appended at
  the end of the file; its dataspace's dimensions and its contiguous
  layout's address and size are rewritten in place (fixed-width fields of
  the version-1 object header), and so is the superblock's end-of-file
  address (superblocks 0 and 1 have no checksum);
- anything else (another rank, compact storage, another layout or
  dataspace version) raises, naming the dataset.

The result loads through the port's loader, the JAX package's h5py loader
and ``tf.keras.models.load_model``.
"""

import json
import struct
import zipfile
from pathlib import Path

import numpy as np
import torch

from audio_analysis_torch.io import h5read

_UINT = {1: "B", 2: "H", 4: "I", 8: "Q"}


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _put_uint(buf, pos, size, value):
    struct.pack_into("<" + _UINT[size], buf, pos, value)


def _relocate(h5: bytearray, ds: h5read.Dataset, raw: bytes, shape, name):
    """Point dataset `ds` at `raw`, appended to the file, with dimensions
    `shape` (same rank)."""
    sb = h5read.superblock(h5)
    msgs = {}
    for mtype, pos, size in h5read.object_messages(h5, ds.header):
        msgs.setdefault(mtype, (pos, size))
    sp, lp = msgs[h5read._DATASPACE][0], msgs[h5read._LAYOUT][0]
    version, rank, flags = h5[sp], h5[sp + 1], h5[sp + 2]
    if version != 1:
        raise ValueError(f"{name}: dataspace version {version} cannot be resized in place")
    if rank != len(shape):
        raise ValueError(f"{name}: rank {rank} -> {len(shape)} cannot be written in place")
    if h5[lp] != 3 or h5[lp + 1] != 1:
        raise ValueError(f"{name}: layout version {h5[lp]}, class {h5[lp + 1]} is not "
                         "contiguous storage (version 3); it cannot be resized in place")
    eof = struct.unpack_from("<" + _UINT[sb.so], h5, sb.eof_at)[0]
    start = max(len(h5), sb.base + eof)
    h5.extend(bytes(start - len(h5)))
    h5.extend(raw)
    dims = sp + 8
    for i, d in enumerate(shape):
        _put_uint(h5, dims + i * sb.sl, sb.sl, d)
        if flags & 0x01:  # maximum dimensions follow: fixed at the new size
            _put_uint(h5, dims + (rank + i) * sb.sl, sb.sl, d)
    _put_uint(h5, lp + 2, sb.so, start - sb.base)
    _put_uint(h5, lp + 2 + sb.so, sb.sl, len(raw))
    _put_uint(h5, sb.eof_at, sb.so, len(h5) - sb.base)


def write_keras_archive(src_path, params, out_path, config=None):
    """Copy the archive at ``src_path`` (or the first ``*.keras`` in that
    dir) to ``out_path`` with the variable values replaced by ``params``
    ({weight_key: [arrays or tensors]}, ``KerasModel.params``' layout,
    cast to each dataset's dtype). Keys absent from ``params`` keep their
    values; a key or variable the archive lacks raises KeyError.
    ``config``: a replacement config dict, written as config.json."""
    src_path = Path(src_path)
    if src_path.is_dir():
        candidates = sorted(src_path.glob("*.keras"))
        if not candidates:
            raise FileNotFoundError(f"no .keras archive in {src_path}")
        src_path = candidates[0]
    with zipfile.ZipFile(src_path) as z:
        infos = z.infolist()
        members = {i.filename: z.read(i) for i in infos}

    h5 = bytearray(members["model.weights.h5"])
    tree = h5read.read_h5(bytes(h5))
    root = tree.get("layers", tree)
    for key, arrays in params.items():
        group = root
        for part in key.split("/") + ["vars"]:
            group = group.get(part) if isinstance(group, dict) else None
            if group is None:
                raise KeyError(f"weight key {key!r} not present in the archive")
        for i, arr in enumerate(arrays):
            ds = group.get(str(i))
            if not isinstance(ds, h5read.Dataset):
                raise KeyError(f"variable {key}/vars/{i} not in the archive")
            arr = np.array(_host(arr), dtype=ds.array.dtype, order="C")  # 0-d stays 0-d
            raw = arr.tobytes()
            if arr.shape == ds.array.shape:
                if raw:
                    h5[ds.offset : ds.offset + len(raw)] = raw
            else:  # a replaced head
                _relocate(h5, ds, raw, arr.shape, f"{key}/vars/{i}")
    members["model.weights.h5"] = bytes(h5)
    if config is not None:
        members["config.json"] = json.dumps(config).encode()

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(out_path, "w") as z:
        for info in infos:
            keep = zipfile.ZipInfo(info.filename, info.date_time)
            keep.compress_type, keep.external_attr = info.compress_type, info.external_attr
            z.writestr(keep, members[info.filename])
    return out_path
