"""TSV storage engine: seekable TSV + ``.lineidx`` byte offsets.

Counterpart of ``lighthand_tpu/data/tsv.py`` (reference
src/utils/tsv_file.py:39-160 and tsv_file_ops.py:38-116): rows are
tab-separated lines, a sidecar ``.lineidx`` holds one byte offset per row,
images are base64-encoded JPEGs in the last column. Readers keep one file
handle per thread.

Differences from the JAX package: lineidx generation, bulk row reads and
base64 go through the port's TSV engine (``data/native.py``) on one path,
with no Python fallback; ``img_from_base64`` decodes through the port's
codec (``data/imageio.py``), returns RGB rather than BGR and raises on data
it cannot decode; ``img_to_base64`` takes the RGB image and encodes it with
the port's encoder (the bytes cv2 writes for the BGR one).
"""

from __future__ import annotations

import base64
import json
import os
import os.path as op
import shutil
import threading
from typing import Iterable, List, Optional, Sequence

import numpy as np
import yaml

from lighthand_tpu_torch.data import native
from lighthand_tpu_torch.data.imageio import encode_jpeg_rgb, imdecode_rgb


def generate_lineidx(tsv_path: str, idx_path: Optional[str] = None) -> str:
    """Scan a TSV once and write byte offsets, one per line."""
    idx_path = idx_path or op.splitext(tsv_path)[0] + ".lineidx"
    tmp = idx_path + ".tmp"
    native.generate_lineidx(tsv_path, tmp)
    os.replace(tmp, idx_path)
    return idx_path


def _split(row: bytes) -> List[str]:
    return [s.strip() for s in row.decode("utf-8").split("\t")]


class TSVFile:
    """Random-access TSV reader with thread-local file handles."""

    def __init__(self, tsv_path: str, generate_index: bool = True):
        self.tsv_path = tsv_path
        self.lineidx_path = op.splitext(tsv_path)[0] + ".lineidx"
        if not op.isfile(self.lineidx_path) and generate_index:
            generate_lineidx(tsv_path, self.lineidx_path)
        self._offsets: Optional[np.ndarray] = None
        self._local = threading.local()

    def _ensure_offsets(self) -> np.ndarray:
        if self._offsets is None:
            self._offsets = np.loadtxt(self.lineidx_path, dtype=np.int64,
                                       ndmin=1)
        return self._offsets

    def _fp(self):
        fp = getattr(self._local, "fp", None)
        if fp is None or getattr(self._local, "pid", None) != os.getpid():
            fp = open(self.tsv_path, "rb")
            self._local.fp = fp
            self._local.pid = os.getpid()
        return fp

    def num_rows(self) -> int:
        return int(self._ensure_offsets().shape[0])

    def seek(self, idx: int) -> List[str]:
        offsets = self._ensure_offsets()
        fp = self._fp()
        fp.seek(int(offsets[idx]))
        return _split(fp.readline())

    def read_rows(self, indices) -> List[List[str]]:
        """Bulk random-access read of many rows in one engine call."""
        rows = native.read_rows(self.tsv_path, self._ensure_offsets(),
                                [int(i) for i in indices])
        return [_split(r) for r in rows]

    def get_key(self, idx: int) -> str:
        return self.seek(idx)[0]

    def __getitem__(self, idx: int) -> List[str]:
        return self.seek(idx)

    def __len__(self) -> int:
        return self.num_rows()


class CompositeTSVFile:
    """Multi-shard TSV addressed through a (source, row) sequence file
    (reference tsv_file.py:110-151)."""

    def __init__(self, file_list, seq_file: str, root: str = "."):
        if isinstance(file_list, str):
            with open(file_list) as f:
                self.file_list = [ln.strip() for ln in f if ln.strip()]
        else:
            self.file_list = list(file_list)
        self.seq: List[tuple[int, int]] = []
        with open(seq_file) as f:
            for line in f:
                a, b = line.strip().split("\t")
                self.seq.append((int(a), int(b)))
        self.tsvs = [TSVFile(op.join(root, p)) for p in self.file_list]

    def num_rows(self) -> int:
        return len(self.seq)

    def get_key(self, index: int) -> str:
        src, row = self.seq[index]
        return "_".join([self.file_list[src], self.tsvs[src].get_key(row)])

    def __getitem__(self, index: int) -> List[str]:
        src, row = self.seq[index]
        return self.tsvs[src].seek(row)

    def __len__(self) -> int:
        return len(self.seq)


def tsv_writer(rows: Iterable[Sequence[str]], tsv_path: str) -> None:
    """Write rows + lineidx atomically (reference tsv_file_ops.py:38-54)."""
    lineidx_path = op.splitext(tsv_path)[0] + ".lineidx"
    os.makedirs(op.dirname(op.abspath(tsv_path)), exist_ok=True)
    tsv_tmp, idx_tmp = tsv_path + ".tmp", lineidx_path + ".tmp"
    with open(tsv_tmp, "wb") as fd, open(idx_tmp, "w") as fi:
        pos = 0
        for row in rows:
            data = ("\t".join(str(v) for v in row) + "\n").encode("utf-8")
            fd.write(data)
            fi.write(f"{pos}\n")
            pos += len(data)
    os.replace(tsv_tmp, tsv_path)
    os.replace(idx_tmp, lineidx_path)


def tsv_reader(tsv_path: str):
    with open(tsv_path, "r") as f:
        for line in f:
            yield [x.strip() for x in line.split("\t")]


def concat_tsv_files(tsvs: Sequence[str], out_tsv: str) -> None:
    """Concatenate TSV shards into one file + merged lineidx with offsets
    rebased by the cumulative byte sizes (reference
    miscellaneous.py:100-133)."""
    os.makedirs(op.dirname(op.abspath(out_tsv)), exist_ok=True)
    out_tmp = out_tsv + ".tmp"
    idx_tmp = op.splitext(out_tsv)[0] + ".lineidx.tmp"
    try:
        with open(out_tmp, "wb") as fd:
            for t in tsvs:
                with open(t, "rb") as fi:
                    shutil.copyfileobj(fi, fd, 10 * 1024 * 1024)
        base = 0
        all_idx: List[str] = []
        for t in tsvs:
            with open(op.splitext(t)[0] + ".lineidx") as f:
                all_idx.extend(str(int(line) + base)
                               for line in f if line.strip())
            base += os.stat(t).st_size
        with open(idx_tmp, "w") as f:
            f.write("\n".join(all_idx) + ("\n" if all_idx else ""))
    except BaseException:
        # leave no half-written .tmp files behind
        for p in (out_tmp, idx_tmp):
            try:
                os.unlink(p)
            except OSError:
                pass
        raise
    os.replace(out_tmp, out_tsv)
    os.replace(idx_tmp, op.splitext(out_tsv)[0] + ".lineidx")


def img_from_base64(s: str | bytes) -> np.ndarray:
    """base64 JPEG -> RGB uint8 [H, W, 3] (reference image_ops.py:16-23,
    which returned BGR)."""
    return imdecode_rgb(native.b64_decode(s), name="<base64 image>")


def img_to_base64(img_rgb: np.ndarray, quality: int = 95) -> str:
    """RGB uint8 [H, W, 3] -> base64 JPEG: the string the JAX package's
    ``img_to_base64`` gives for the same image in BGR."""
    return base64.b64encode(encode_jpeg_rgb(img_rgb, quality)).decode(
        "ascii")


def _config_save_file(tsv_path: str, save_file: Optional[str],
                      append_str: str) -> str:
    """Default output naming (reference tsv_file_ops.py:61-64)."""
    return save_file if save_file is not None \
        else op.splitext(tsv_path)[0] + append_str


def generate_hw_file(img_file: str, save_file: Optional[str] = None) -> str:
    """Write a `.hw.tsv` sidecar: per row ``key \\t [{"height":H,"width":W}]``
    by decoding each image column (reference tsv_file_ops.py:73-85)."""

    def gen_rows():
        for row in tsv_reader(img_file):
            img = img_from_base64(row[-1])
            yield [row[0], json.dumps([{"height": int(img.shape[0]),
                                        "width": int(img.shape[1])}])]

    save_file = _config_save_file(img_file, save_file, ".hw.tsv")
    tsv_writer(gen_rows(), save_file)
    return save_file


def generate_linelist_file(label_file: str, save_file: Optional[str] = None,
                           ignore_attrs: Sequence[str] = ()) -> str:
    """Write a `.linelist.tsv` of row numbers whose label column is
    non-empty, skipping rows where every label carries only ignore-attrs
    (reference tsv_file_ops.py:87-101)."""
    line_list = []
    for i, row in enumerate(tsv_reader(label_file)):
        labels = json.loads(row[1])
        if not labels:
            continue
        if ignore_attrs and all(
            any(lab[attr] for attr in ignore_attrs if attr in lab)
            for lab in labels
        ):
            continue
        line_list.append([i])
    save_file = _config_save_file(label_file, save_file, ".linelist.tsv")
    tsv_writer(line_list, save_file)
    return save_file


def load_from_yaml_file(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def find_file_path_in_yaml(fname: Optional[str], root: str) -> Optional[str]:
    if fname is None:
        return None
    if op.isfile(fname):
        return fname
    candidate = op.join(root, fname)
    if op.isfile(candidate):
        return candidate
    raise FileNotFoundError(f"{fname} (root={root})")
