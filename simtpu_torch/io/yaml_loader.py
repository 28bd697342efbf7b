"""YAML manifest ingestion.

Mirrors the reference's file-walking + decode pipeline:
- recursive directory walk, files sorted per directory, only .yaml/.yml loaded
  (`pkg/utils/utils.go:44-71,90-101,117-131`)
- multi-document YAML decode with unknown kinds skipped
  (`pkg/simulator/utils.go:139-183`)
"""

from __future__ import annotations

import os
from typing import List

import yaml

from ..core.objects import ResourceTypes


def parse_file_paths(path: str) -> List[str]:
    """Recursively collect regular files under path, directory-sorted.

    The top-level path must exist; odd directory entries (broken symlinks,
    sockets) are skipped, and symlinked directories are visited once.
    """
    if os.path.isfile(path):
        return [path]
    if not os.path.isdir(path):
        raise FileNotFoundError(f"invalid path: {path}")
    out: List[str] = []
    seen_dirs = {os.path.realpath(path)}

    def walk(d: str) -> None:
        for entry in sorted(os.listdir(d)):
            p = os.path.join(d, entry)
            if os.path.isfile(p):
                out.append(p)
            elif os.path.isdir(p):
                real = os.path.realpath(p)
                if real not in seen_dirs:
                    seen_dirs.add(real)
                    walk(p)

    walk(path)
    return out


class SourcedText(str):
    """A YAML document string that remembers its manifest file, so spec
    diagnostics (`workloads.validate.SpecError`) can name it.  Plain-str
    everywhere else — consumers that don't care never notice."""

    source: str = ""

    def __new__(cls, text: str, source: str):
        self = super().__new__(cls, text)
        self.source = source
        return self


def get_yaml_content_from_directory(path: str) -> List[str]:
    """Return raw YAML strings for every .yaml/.yml under path (each one
    a `SourcedText` carrying its file path)."""
    docs = []
    for fp in parse_file_paths(path):
        if os.path.splitext(fp)[1] in (".yaml", ".yml"):
            with open(fp) as f:
                docs.append(SourcedText(f.read(), fp))
    return docs


def decode_yaml_content(text: str) -> List[dict]:
    """Split a (possibly multi-document) YAML string into object dicts."""
    objs = []
    for doc in yaml.safe_load_all(text):
        if isinstance(doc, dict) and doc.get("kind"):
            objs.append(doc)
    return objs


def get_objects_from_yaml_content(docs: List[str]) -> ResourceTypes:
    """Type-switch decoded docs into ResourceTypes; unknown kinds are
    skipped (reference parity — app bundles legitimately carry Services,
    ConfigMaps...).  Objects from `SourcedText` docs are stamped with
    their manifest file for spec diagnostics."""
    from ..workloads.expand import SOURCE_KEY

    resources = ResourceTypes()
    for text in docs:
        source = getattr(text, "source", None)
        for obj in decode_yaml_content(text):
            if source:
                obj[SOURCE_KEY] = source
            resources.add(obj)
    return resources


def load_resources(path: str) -> ResourceTypes:
    """Load every manifest under a file or directory path."""
    return get_objects_from_yaml_content(get_yaml_content_from_directory(path))
