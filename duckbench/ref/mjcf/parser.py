"""MJCF XML parser: includes, defaults classes, worldbody tree -> python spec.

Covers the MJCF subset used by the Open Duck Mini v2 scenes
(reference xmls/: scene_*.xml, open_duck_mini_v2*.xml, sensors via
joints_properties include blocks). This is a from-scratch implementation of
the relevant MJCF semantics, not a port of the MuJoCo compiler.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


def _fl(s: str) -> np.ndarray:
    return np.asarray([float(x) for x in s.replace("\n", " ").split()], dtype=np.float64)


@dataclass
class ElemSpec:
    """One parsed element with defaults-resolved attributes."""

    tag: str
    attrs: Dict[str, str]

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self.attrs.get(key, default)

    def vec(self, key: str, default) -> np.ndarray:
        v = self.attrs.get(key)
        if v is None:
            return np.asarray(default, dtype=np.float64)
        return _fl(v)

    def num(self, key: str, default: float) -> float:
        v = self.attrs.get(key)
        return default if v is None else float(v)


@dataclass
class BodySpec:
    name: str
    pos: np.ndarray
    quat: np.ndarray
    inertial: Optional[ElemSpec]
    joints: List[ElemSpec] = field(default_factory=list)
    geoms: List[ElemSpec] = field(default_factory=list)
    sites: List[ElemSpec] = field(default_factory=list)
    children: List["BodySpec"] = field(default_factory=list)


@dataclass
class MjcfSpec:
    model_name: str
    base_dir: str
    meshdir: str
    option: Dict[str, str]
    option_flags: Dict[str, str]
    meshes: List[ElemSpec]
    hfields: List[ElemSpec]
    worldbody: BodySpec
    actuators: List[ElemSpec]
    sensors: List[ElemSpec]
    keyframes: List[ElemSpec]


class _Defaults:
    """MJCF default class tree with attribute-wise inheritance."""

    def __init__(self):
        # class name -> {tag -> {attr: value}}
        self.classes: Dict[str, Dict[str, Dict[str, str]]] = {"main": {}}
        self.parent: Dict[str, Optional[str]] = {"main": None}

    def add_block(self, elem: ET.Element, parent_class: str = "main") -> None:
        name = elem.get("class", "main" if parent_class == "main" else None)
        if name is None:
            raise ValueError("nested default block requires a class name")
        if name not in self.classes:
            self.classes[name] = {}
            self.parent[name] = parent_class if name != "main" else None
        for child in elem:
            if child.tag == "default":
                self.add_block(child, parent_class=name)
            else:
                merged = dict(self.classes[name].get(child.tag, {}))
                merged.update(child.attrib)
                self.classes[name][child.tag] = merged

    def resolve(self, tag: str, cls: str) -> Dict[str, str]:
        """Fully-inherited default attrs for an element tag in class `cls`."""
        chain: List[str] = []
        c: Optional[str] = cls
        while c is not None:
            chain.append(c)
            c = self.parent.get(c)
        attrs: Dict[str, str] = {}
        for c in reversed(chain):  # root first, leaf overrides
            attrs.update(self.classes.get(c, {}).get(tag, {}))
        return attrs


def _load_xml_with_includes(path: str) -> ET.Element:
    tree = ET.parse(path)
    root = tree.getroot()
    base = os.path.dirname(os.path.abspath(path))
    _expand_includes(root, base)
    return root


def _expand_includes(root: ET.Element, base: str) -> None:
    """Recursively splice <include file=.../> children into the parent."""
    i = 0
    children = list(root)
    for child in children:
        _expand_includes(child, base)
    while i < len(root):
        child = root[i]
        if child.tag == "include":
            inc_path = os.path.join(base, child.get("file"))
            inc_root = ET.parse(inc_path).getroot()
            _expand_includes(inc_root, os.path.dirname(inc_path))
            root.remove(child)
            for j, inc_child in enumerate(list(inc_root)):
                root.insert(i + j, inc_child)
            i += len(list(inc_root))
        else:
            i += 1


def parse_mjcf(path: str) -> MjcfSpec:
    root = _load_xml_with_includes(path)
    if root.tag != "mujoco":
        raise ValueError(f"not an MJCF file: root tag {root.tag}")

    defaults = _Defaults()
    option: Dict[str, str] = {}
    option_flags: Dict[str, str] = {}
    compiler: Dict[str, str] = {}
    meshes: List[ElemSpec] = []
    hfields: List[ElemSpec] = []
    actuators: List[ElemSpec] = []
    sensors: List[ElemSpec] = []
    keyframes: List[ElemSpec] = []
    worldbody_elems: List[ET.Element] = []

    for section in root:
        tag = section.tag
        if tag == "default":
            defaults.add_block(section)
        elif tag == "option":
            option.update(section.attrib)
            for sub in section:
                if sub.tag == "flag":
                    option_flags.update(sub.attrib)
        elif tag == "compiler":
            compiler.update(section.attrib)
        elif tag == "asset":
            for sub in section:
                if sub.tag == "mesh":
                    attrs = dict(defaults.resolve("mesh", "main"))
                    attrs.update(sub.attrib)
                    if "name" not in attrs:
                        attrs["name"] = os.path.splitext(os.path.basename(attrs["file"]))[0]
                    meshes.append(ElemSpec("mesh", attrs))
                elif sub.tag == "hfield":
                    hfields.append(ElemSpec("hfield", dict(sub.attrib)))
                # textures / materials are visual-only: ignored
        elif tag == "worldbody":
            worldbody_elems.extend(list(section))
        elif tag == "actuator":
            for sub in section:
                attrs = dict(defaults.resolve(sub.tag, sub.get("class", "main")))
                attrs.update(sub.attrib)
                attrs["__kind__"] = sub.tag  # position / motor / velocity
                actuators.append(ElemSpec(sub.tag, attrs))
        elif tag == "sensor":
            for sub in section:
                sensors.append(ElemSpec(sub.tag, dict(sub.attrib)))
        elif tag == "keyframe":
            for sub in section:
                if sub.tag == "key":
                    keyframes.append(ElemSpec("key", dict(sub.attrib)))
        # visual / statistic / equality(empty) / custom: ignored

    angle = compiler.get("angle", "degree")
    if angle != "radian":
        raise NotImplementedError("only angle='radian' MJCF models are supported")

    def parse_body(elem: ET.Element, childclass: str) -> BodySpec:
        cc = elem.get("childclass", childclass)
        body = BodySpec(
            name=elem.get("name", ""),
            pos=_fl(elem.get("pos", "0 0 0")),
            quat=_normalize_quat(_fl(elem.get("quat", "1 0 0 0"))),
            inertial=None,
        )
        for sub in elem:
            t = sub.tag
            if t in ("joint", "freejoint", "geom", "site"):
                tag_for_defaults = "joint" if t == "freejoint" else t
                cls = sub.get("class", cc)
                attrs = dict(defaults.resolve(tag_for_defaults, cls)) if t != "freejoint" else {}
                attrs.update(sub.attrib)
                spec = ElemSpec(t, attrs)
                if t == "freejoint":
                    spec.attrs["type"] = "free"
                    body.joints.append(spec)
                elif t == "joint":
                    spec.attrs.setdefault("type", "hinge")
                    body.joints.append(spec)
                elif t == "geom":
                    body.geoms.append(spec)
                else:
                    body.sites.append(spec)
            elif t == "inertial":
                body.inertial = ElemSpec("inertial", dict(sub.attrib))
            elif t == "body":
                body.children.append(parse_body(sub, cc))
            # lights/cameras ignored
        return body

    world = BodySpec(name="world", pos=np.zeros(3), quat=np.array([1.0, 0, 0, 0]), inertial=None)
    for elem in worldbody_elems:
        if elem.tag == "body":
            world.children.append(parse_body(elem, "main"))
        elif elem.tag == "geom":
            attrs = dict(defaults.resolve("geom", elem.get("class", "main")))
            attrs.update(elem.attrib)
            world.geoms.append(ElemSpec("geom", attrs))
        elif elem.tag == "site":
            attrs = dict(defaults.resolve("site", elem.get("class", "main")))
            attrs.update(elem.attrib)
            world.sites.append(ElemSpec("site", attrs))

    return MjcfSpec(
        model_name=root.get("model", "mjcf"),
        base_dir=os.path.dirname(os.path.abspath(path)),
        meshdir=compiler.get("meshdir", ""),
        option=option,
        option_flags=option_flags,
        meshes=meshes,
        hfields=hfields,
        worldbody=world,
        actuators=actuators,
        sensors=sensors,
        keyframes=keyframes,
    )


def _normalize_quat(q: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(q)
    return q / n if n > 0 else np.array([1.0, 0, 0, 0])
