"""Traffic: a mix's parameters (``perfbench/traffic/<name>.json``) and the
generator that the file names (``"generator"``, a module
``perfbench/generators/<generator>.py``).

A generator gives ``make_corpus(spec, seed, root)``, the corpus of a run
seed, and ``make_dataset(corpus, preprocessor)``, the port's dataset over
it, which the harness batches with ``utils.data_loader``.  A new mix of an
existing kind is a new data file; a new kind of input is a new generator
beside the others.
"""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Corpus:
    texts: list      # str: each sample's transcript
    images: list     # [features, frames] arrays: each sample's input
    chars: list      # the transcripts' characters, sorted


def load(path):
    with open(path) as fid:
        return json.load(fid)


_GENERATORS = {}


def generator(spec, root):
    """The generator module that ``spec`` names."""
    path = Path(root) / "perfbench/generators" / f"{spec['generator']}.py"
    if path not in _GENERATORS:
        mod_spec = importlib.util.spec_from_file_location(
            f"perfbench_generator_{spec['generator']}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        _GENERATORS[path] = mod
    return _GENERATORS[path]


def make_corpus(spec, seed, root):
    return generator(spec, root).make_corpus(spec, seed, root)


def make_dataset(spec, root, corpus, preprocessor):
    return generator(spec, root).make_dataset(corpus, preprocessor)
