"""Lightweight FAIR dataset packaging (dtool-compatible layout).

The reference stores every MD run as an immutable dtool dataset — a
directory with a ``data/`` payload, ``README.yml`` metadata, and an
admin manifest (reference GaPFlow/md/base.py:163-239, db.py:193-235).
dtoolcore is not a hard dependency here; this module provides the same
on-disk layout and the API surface GaPFlow actually uses:

- :func:`create_proto_dataset` -> proto dataset with ``put_item``/``freeze``
- :func:`iter_datasets_in_base_uri` -> frozen datasets with
  ``get_readme_content``, ``uuid`` and ``name``

The directory layout matches dtool's disk storage broker
(``.dtool/`` admin dir with a manifest and a frozen marker), so datasets
written here can be adopted by real dtool tooling and vice versa.
"""

import hashlib
import json
import os
import shutil
import uuid as _uuid
from datetime import datetime, timezone


_ADMIN = ".dtool"


class ProtoDataset:
    """A dataset under construction: add items, then freeze."""

    def __init__(self, name, base_uri):
        self.name = name
        self.uuid = str(_uuid.uuid4())
        self.base_path = os.path.abspath(base_uri.replace("file://", ""))
        self.path = os.path.join(self.base_path, name)
        self.data_path = os.path.join(self.path, "data")
        os.makedirs(self.data_path)
        os.makedirs(os.path.join(self.path, _ADMIN))
        self._write_admin("dtool", {
            "uuid": self.uuid,
            "name": name,
            "type": "protodataset",
            "created_at": datetime.now(timezone.utc).isoformat(),
        })

    @property
    def uri(self):
        return "file://" + self.path

    def _write_admin(self, fname, payload):
        with open(os.path.join(self.path, _ADMIN, fname), "w") as fh:
            json.dump(payload, fh, indent=2)

    def put_item(self, src, relpath):
        """Copy a file into the dataset payload under ``data/relpath``."""
        dst = os.path.join(self.data_path, relpath)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(src, dst)
        return relpath

    def freeze(self):
        """Finalize: write the item manifest and mark the dataset frozen."""
        items = {}
        for root, _, files in os.walk(self.data_path):
            for f in files:
                full = os.path.join(root, f)
                rel = os.path.relpath(full, self.data_path)
                with open(full, "rb") as fh:
                    digest = hashlib.md5(fh.read()).hexdigest()
                items[digest] = {
                    "relpath": rel,
                    "size_in_bytes": os.path.getsize(full),
                    "utc_timestamp": os.path.getmtime(full),
                }
        self._write_admin("manifest.json", {
            "items": items,
            "dtoolcore_version": "gapflow-torch-minimal",
            "hash_function": "md5sum_hexdigest",
        })
        self._write_admin("dtool", {
            "uuid": self.uuid,
            "name": self.name,
            "type": "dataset",
            "frozen_at": datetime.now(timezone.utc).isoformat(),
        })
        return FrozenDataset(self.path)


class FrozenDataset:
    """A read-only view of a frozen dataset directory."""

    def __init__(self, path):
        self.path = os.path.abspath(path)
        admin = os.path.join(self.path, _ADMIN, "dtool")
        if os.path.exists(admin):
            with open(admin) as fh:
                meta = json.load(fh)
            self.uuid = meta.get("uuid", "")
            self.name = meta.get("name", os.path.basename(path))
            self._type = meta.get("type", "dataset")
        else:
            self.uuid = ""
            self.name = os.path.basename(path)
            self._type = "dataset"

    @property
    def is_frozen(self):
        return self._type == "dataset"

    def get_readme_content(self):
        readme = os.path.join(self.path, "README.yml")
        if not os.path.exists(readme):
            return ""
        with open(readme) as fh:
            return fh.read()


def create_proto_dataset(name, base_uri):
    return ProtoDataset(name, base_uri)


def iter_datasets_in_base_uri(base_uri):
    """Yield every (frozen) dataset found directly under ``base_uri``."""
    base = os.path.abspath(str(base_uri).replace("file://", ""))
    if not os.path.isdir(base):
        return
    for entry in sorted(os.listdir(base)):
        path = os.path.join(base, entry)
        if os.path.isdir(path) and os.path.isdir(os.path.join(path, _ADMIN)):
            ds = FrozenDataset(path)
            if ds.is_frozen:
                yield ds
