"""The `simon/v1alpha1 Config` CR schema and loader.

Mirrors `pkg/api/v1alpha1/types.go:1-29` and the validation in
`pkg/apply/apply.go:247-284`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

import yaml


@dataclass
class AppInfo:
    name: str
    path: str
    chart: bool = False


@dataclass
class Cluster:
    custom_config: str = ""
    kube_config: str = ""


@dataclass
class SimonConfig:
    cluster: Cluster
    app_list: List[AppInfo] = field(default_factory=list)
    new_node: str = ""

    @classmethod
    def from_file(cls, path: str) -> "SimonConfig":
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        if doc.get("kind") != "Config":
            raise ValueError(f"{path}: not a simon Config CR (kind={doc.get('kind')!r})")
        spec = doc.get("spec") or {}
        cluster = spec.get("cluster") or {}
        apps = [
            AppInfo(
                name=a.get("name", ""),
                path=a.get("path", ""),
                chart=bool(a.get("chart", False)),
            )
            for a in spec.get("appList") or []
        ]
        return cls(
            cluster=Cluster(
                custom_config=cluster.get("customConfig", "") or "",
                kube_config=cluster.get("kubeConfig", "") or "",
            ),
            app_list=apps,
            new_node=spec.get("newNode", "") or "",
        )


def validate_config(cfg: SimonConfig, scheduler_config: str = "") -> None:
    """Path/exclusivity validation (`pkg/apply/apply.go:247-284`)."""
    has_kube = bool(cfg.cluster.kube_config)
    has_custom = bool(cfg.cluster.custom_config)
    if has_kube == has_custom:
        raise ValueError("only one of kubeConfig and customConfig must be set")
    for what, path in (
        ("kubeConfig", cfg.cluster.kube_config),
        ("customConfig", cfg.cluster.custom_config),
        ("scheduler config", scheduler_config),
        ("newNode", cfg.new_node),
    ):
        if path and not os.path.exists(path):
            raise ValueError(f"invalid path of {what}: {path}")
    for app in cfg.app_list:
        if not os.path.exists(app.path):
            raise ValueError(f"invalid path of {app.name} app: {app.path}")
