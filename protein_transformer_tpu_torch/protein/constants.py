"""Structure dimensionality constants (the port's own copy of
protein_transformer_tpu/protein/constants.py).

Mirrors the reference's structure constants (reference: protein/Structure.py:4-9):
12 predicted interior angles per residue (3 backbone torsions phi/psi/omega,
3 backbone bond angles, 6 sidechain chi angles) and 14 cartesian coordinate
slots per residue (4 backbone atoms N/CA/C/O + up to 10 sidechain atoms).
"""

NUM_PREDICTED_ANGLES = 12
NUM_PREDICTED_COORDS = 14
NUM_BB_TORSION_ANGLES = 3
NUM_BB_OTHER_ANGLES = 3
NUM_SC_ANGLES = NUM_PREDICTED_ANGLES - (NUM_BB_OTHER_ANGLES + NUM_BB_TORSION_ANGLES)
SC_ANGLES_START_POS = NUM_BB_OTHER_ANGLES + NUM_BB_TORSION_ANGLES

# Number of backbone atom slots (N, CA, C, O) out of the 14 per-residue slots.
NUM_BB_ATOMS = 4

# Maximum residues per protein; longer chains are truncated at data load time
# (reference: dataset.py:10).
MAX_SEQ_LEN = 500
