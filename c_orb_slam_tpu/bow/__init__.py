"""Bag-of-binary-words place recognition (array-program DBoW2 equivalent).

Reference: Thirdparty/DBoW2 — TemplatedVocabulary.h (k^L tree, greedy
descent transform :1218-1259), FORB.cpp (popcount distance :81, bitwise
majority mean :28-77), BowVector/FeatureVector, ScoringObject.cpp;
KeyFrameDatabase.cc (inverted file).

Array-program design (SURVEY.md §2.2): the vocabulary is dense arrays (node
descriptors + children table); transform is a batched fixed-depth descent
(vmapped gather + Hamming argmin); keyframe BoW vectors are fixed-capacity
sparse (word_id, weight) arrays; scoring a query against ALL keyframes is one
batched gather against a dense query histogram — no inverted file needed (the
inverted file is a CPU sparse-scoring optimization; dense-batched scoring is
the array-program shape of the same query).
"""

from c_orb_slam_tpu.bow.vocab import Vocabulary, train_vocabulary
from c_orb_slam_tpu.bow.database import KeyFrameDatabase

__all__ = ["Vocabulary", "train_vocabulary", "KeyFrameDatabase"]
