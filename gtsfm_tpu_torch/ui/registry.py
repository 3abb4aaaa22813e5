"""Process registry and dataflow graph.

Port of gtsfm_tpu/ui/registry.py: a metaclass collects every pipeline
process class that declares ``get_ui_metadata()`` (display name, input and
output products, parent plate), and ``ProcessGraphGenerator`` writes the
registered pipeline as Graphviz DOT text with one cluster per plate. The
scene optimizer saves it with every run as ``results/process_graph.dot``.
Plain Python, the reference's text.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UiMetadata:
    display_name: str
    input_products: Tuple[str, ...]
    output_products: Tuple[str, ...]
    parent_plate: str = ""


class RegistryMeta(type):
    """Metaclass collecting every process class that declares
    get_ui_metadata()."""

    REGISTRY: dict = {}

    def __new__(mcs, name, bases, attrs):
        cls = super().__new__(mcs, name, bases, attrs)
        if name != "GTSFMProcess" and "get_ui_metadata" in attrs:
            RegistryMeta.REGISTRY[name] = cls
        return cls


class GTSFMProcess(metaclass=RegistryMeta):
    """Base of the registered pipeline processes."""

    @staticmethod
    def get_ui_metadata() -> UiMetadata:  # pragma: no cover - abstract
        raise NotImplementedError


class RetrieverProcess(GTSFMProcess):
    @staticmethod
    def get_ui_metadata() -> UiMetadata:
        return UiMetadata("Retriever", ("Images",), ("Image Pair Indices",), "Retrieval")


class DetectorDescriptorProcess(GTSFMProcess):
    @staticmethod
    def get_ui_metadata() -> UiMetadata:
        return UiMetadata("DetectorDescriptor", ("Images",), ("Keypoints", "Descriptors"), "Front-end")


class TwoViewEstimatorProcess(GTSFMProcess):
    @staticmethod
    def get_ui_metadata() -> UiMetadata:
        return UiMetadata(
            "TwoViewEstimator",
            ("Keypoints", "Descriptors", "Image Pair Indices", "Camera Intrinsics"),
            ("Relative Rotations", "Relative Translations", "Verified Correspondences"),
            "Front-end",
        )


class ViewGraphEstimatorProcess(GTSFMProcess):
    @staticmethod
    def get_ui_metadata() -> UiMetadata:
        return UiMetadata("ViewGraphEstimator", ("Relative Rotations",), ("View Graph",), "Back-end")


class RotationAveragingProcess(GTSFMProcess):
    @staticmethod
    def get_ui_metadata() -> UiMetadata:
        return UiMetadata("RotationAveraging", ("View Graph", "Relative Rotations"), ("Global Rotations",),
                          "Back-end")


class TranslationAveragingProcess(GTSFMProcess):
    @staticmethod
    def get_ui_metadata() -> UiMetadata:
        return UiMetadata("TranslationAveraging", ("Global Rotations", "Relative Translations"),
                          ("Global Translations",), "Back-end")


class DataAssociationProcess(GTSFMProcess):
    @staticmethod
    def get_ui_metadata() -> UiMetadata:
        return UiMetadata("DataAssociation",
                          ("Verified Correspondences", "Global Rotations", "Global Translations"),
                          ("3D Tracks",), "Back-end")


class BundleAdjustmentProcess(GTSFMProcess):
    @staticmethod
    def get_ui_metadata() -> UiMetadata:
        return UiMetadata("BundleAdjustment", ("3D Tracks", "Global Rotations", "Global Translations"),
                          ("SfmData",), "Back-end")


class MVSProcess(GTSFMProcess):
    @staticmethod
    def get_ui_metadata() -> UiMetadata:
        return UiMetadata("PlaneSweepMVS", ("SfmData", "Images"), ("Dense Point Cloud",), "Densify")


class SplatProcess(GTSFMProcess):
    @staticmethod
    def get_ui_metadata() -> UiMetadata:
        return UiMetadata("GaussianSplatting", ("SfmData", "Images"), ("Gaussian Splats",), "Densify")


class ProcessGraphGenerator:
    """The registered pipeline as Graphviz DOT with plate clusters."""

    def to_dot(self) -> str:
        lines = ["digraph gtsfm_tpu {", "  rankdir=LR;", "  node [shape=box, style=rounded];"]
        plates: dict = {}
        for cls in RegistryMeta.REGISTRY.values():
            meta = cls.get_ui_metadata()
            plates.setdefault(meta.parent_plate or "pipeline", []).append(meta)
        products = set()
        for i, (plate, metas) in enumerate(plates.items()):
            lines.append(f'  subgraph cluster_{i} {{ label="{plate}";')
            for m in metas:
                lines.append(f'    "{m.display_name}" [fillcolor="#cfe2ff", style="rounded,filled"];')
            lines.append("  }")
            for m in metas:
                for p in m.input_products:
                    products.add(p)
                    lines.append(f'  "{p}" -> "{m.display_name}";')
                for p in m.output_products:
                    products.add(p)
                    lines.append(f'  "{m.display_name}" -> "{p}";')
        for p in sorted(products):
            lines.append(f'  "{p}" [shape=ellipse, fillcolor="#fff3cd", style=filled];')
        lines.append("}")
        return "\n".join(lines)

    def save_graph(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_dot())
