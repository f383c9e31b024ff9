"""AMBER ff14SB build constants as dense arrays (GENERATED FILE).

Generated by tools/gen_build_tables.py from the AMBER ff14SB
forcefield constants (cf. reference SidechainBuildInfo.py:1-585 and
data/development/forcefields/). Arrays live in
ff14sb_tables.npz; do not edit by hand. This module and the table file are
the port's own copies of the JAX package's.

Array layout: rows indexed by vocabulary amino-acid id (0..19 =
'ACDEFGHIKLMNPQRSTVWY', 20=pad, 21=unk, 22=sos, 23=eos; non-AA rows zero).
Sidechain slots are in build order. Torsion resolution:
  type==1 (predicted): torsion = chi[src_slot] - pi_offset
  type==0 (constant):  torsion = const       - pi_offset
"""
import os

import numpy as np

MAX_SC_ATOMS = 10
ANCHOR_IDX = 14
TORSION_CONST = 0
TORSION_PRED = 1

_z = np.load(os.path.join(os.path.dirname(__file__),
                          "ff14sb_tables.npz"))

SC_NUM_ATOMS = _z['sc_num_atoms']
SC_BOND_LEN = _z['sc_bond_len']
SC_BOND_ANG = _z['sc_bond_ang']
SC_TORSION_TYPE = _z['sc_torsion_type']
SC_TORSION_CONST = _z['sc_torsion_const']
SC_TORSION_SRC = _z['sc_torsion_src']
SC_TORSION_PI_OFFSET = _z['sc_torsion_pi_offset']
SC_FRAME_IDX = _z['sc_frame_idx']

# Backbone bond lengths/angles (radians, Angstroms)
BB_CONST = {str(k): float(v) for k, v in
            zip(_z['bb_names'], _z['bb_values'])}

# Per-AA atom names for the 14 coordinate slots (PDB export)
ATOM_NAMES_14 = [[str(n) for n in row]
                 for row in _z['atom_names']]
