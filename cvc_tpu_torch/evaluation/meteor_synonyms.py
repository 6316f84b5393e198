"""Built-in synonym table for the METEOR 1.5 port (`meteor.py`; the port's
own copy of `cvc_tpu/evaluation/meteor_synonyms.py`).

The METEOR jar resolves its synonym module against WordNet synsets. Where
no WordNet export is at hand, this module provides:

1. a curated caption-domain table (~150 symmetric groups of common English
   synonyms, written from general usage, not a WordNet extract) so the
   stage fires on realistic caption text by default, and
2. a loader hook (`CVC_METEOR_SYNONYMS` env var or explicit path) for a
   full exchange file, one whitespace-separated synonym group per line,
   for deployments with a WordNet export.

The curated table under-matches the jar on rare words; scores equal the
jar's on synonym-free text either way.
"""

from __future__ import annotations

import os
from functools import lru_cache

# Hand-curated symmetric synonym groups, caption-domain English.
_GROUPS = [
    # size / quantity
    "big large huge enormous giant",
    "small little tiny",
    "many numerous several",
    "couple pair two",
    # people
    "man guy gentleman male",
    "woman lady female",
    "kid child youngster",
    "kids children",
    "boy lad",
    "person individual human",
    "people persons crowd",
    "baby infant toddler",
    # common caption verbs
    "walk stroll",
    "walking strolling",
    "run sprint jog",
    "running sprinting jogging",
    "sit rest",
    "sitting seated resting",
    "stand standing",
    "look watch gaze stare",
    "looking watching gazing staring",
    "hold grasp grip carry",
    "holding grasping gripping carrying",
    "talk speak chat converse",
    "talking speaking chatting conversing",
    "ride riding",
    "jump leap hop",
    "jumping leaping hopping",
    "eat consume",
    "eating consuming dining",
    "play playing",
    "smile grin",
    "smiling grinning",
    "throw toss hurl",
    "throwing tossing hurling",
    "catch grab",
    "catching grabbing",
    "climb scale",
    "climbing scaling",
    "cut slice chop",
    "cutting slicing chopping",
    "cook prepare",
    "cooking preparing",
    "wear don",
    "wearing dressed clothed",
    "begin start commence",
    "fast quick rapid speedy",
    "slow sluggish",
    # scene / place
    "photo photograph picture image",
    "street road roadway",
    "sidewalk pavement",
    "store shop",
    "house home residence",
    "building structure",
    "mountain mount peak",
    "hill slope",
    "ocean sea",
    "stream creek brook",
    "forest woods woodland",
    "field meadow pasture",
    "yard lawn",
    "path trail track",
    "city town",
    "beach shore seashore coast",
    "rock stone boulder",
    "ground floor",
    "lake pond",
    # objects
    "car automobile vehicle",
    "bike bicycle cycle",
    "motorbike motorcycle",
    "bus coach",
    "boat ship vessel",
    "plane airplane aircraft jet",
    "tv television",
    "sofa couch settee",
    "cellphone phone telephone mobile",
    "laptop computer notebook",
    "bag sack pouch",
    "purse handbag",
    "cup mug",
    "plate dish platter",
    "garbage trash rubbish refuse",
    "cap hat",
    "jacket coat",
    "trousers pants slacks",
    "sneakers shoes trainers",
    "spectacles glasses eyeglasses",
    "present gift",
    "sign signboard placard",
    "umbrella parasol",
    "rifle gun firearm",
    "knife blade",
    "pot pan",
    "bottle flask",
    "stick branch twig",
    "rope cord line",
    "fence railing barrier",
    "wall barricade",
    "table desk",
    "seat chair bench",
    "candy sweets",
    "cookie biscuit",
    "fries chips",
    # animals
    "dog canine puppy pup hound",
    "cat feline kitten kitty",
    "horse pony stallion mare",
    "cow cattle bovine",
    "bird fowl",
    "bunny rabbit hare",
    "pig hog swine",
    "sheep lamb ewe",
    "monkey ape primate",
    # attributes
    "happy glad joyful cheerful",
    "sad unhappy sorrowful",
    "angry mad furious",
    "pretty beautiful lovely attractive gorgeous",
    "ugly unattractive hideous",
    "old elderly aged",
    "young youthful juvenile",
    "new brand-new",
    "dirty filthy grimy soiled",
    "clean spotless",
    "wet damp moist soaked",
    "dry arid",
    "cold chilly freezing frigid",
    "hot scorching",
    "warm cozy",
    "dark dim gloomy shadowy",
    "bright luminous shiny",
    "tall high lofty",
    "short brief",
    "wide broad",
    "narrow slim thin slender",
    "round circular",
    "near close nearby",
    "far distant remote",
    "empty vacant bare",
    "full filled crowded packed",
    "colorful vibrant vivid",
    "crimson red scarlet",
    "grey gray",
    "quick swift",
    "silent quiet hushed",
    "loud noisy",
    "smiling beaming",
    "wooden timber",
    "metal metallic steel",
    "stone rocky",
    # relations / misc
    "beside alongside next",
    "under beneath underneath below",
    "above over",
    "middle center centre midst",
    "front fore",
    "rear back behind",
    "group cluster bunch",
    "edge border rim brink",
    "top summit peak",
    "bottom base foot",
]


def _build(groups) -> dict[str, frozenset]:
    table: dict[str, set] = {}
    for g in groups:
        words = g.split()
        for w in words:
            table.setdefault(w, set()).update(x for x in words if x != w)
    return {w: frozenset(s) for w, s in table.items()}


@lru_cache(maxsize=4)
def load_synonyms(path: str | None = None) -> dict[str, frozenset]:
    """Synonym table for `meteor.corpus_meteor(..., synonyms=...)`.

    path (or $CVC_METEOR_SYNONYMS): optional exchange file, one
    whitespace-separated synonym group per line, '#' comments — e.g. a
    WordNet synset export.  Groups from the file EXTEND the built-in
    curated table.
    """
    path = path or os.environ.get("CVC_METEOR_SYNONYMS")
    groups = list(_GROUPS)
    if path and os.path.exists(path):
        with open(path, errors="replace") as f:
            for line in f:
                line = line.split("#", 1)[0].strip().lower()
                if len(line.split()) >= 2:
                    groups.append(line)
    return _build(tuple(groups))
