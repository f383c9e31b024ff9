"""Typed exceptions classifying structure-preprocessing failures (the
port's own copy of protein_transformer_tpu/protein/structure_exceptions.py;
reference: protein/structure_exceptions.py:1-46)."""


class StructureError(Exception):
    """Base class for structure preprocessing failures."""


class IncompleteStructureError(StructureError):
    """A structure is missing residues required for measurement."""


class NonStandardAminoAcidError(StructureError):
    """A structure contains a non-standard amino acid."""


class SequenceError(StructureError):
    """A sequence could not be obtained or does not match expectations."""


class ContigMultipleMatchingError(StructureError):
    """An observed contig matches the target sequence in multiple places."""


class ShortStructureError(StructureError):
    """A structure is too short to be used."""


class MissingAtomsError(StructureError):
    """Atoms required for an angle measurement are missing."""


class NoneStructureError(StructureError):
    """A structure could not be parsed at all."""


class MissingFileError(NoneStructureError):
    """No structure file is available for this id (distinct from parse
    failures so failure reports attribute build problems correctly)."""


class NanValuesError(StructureError):
    """Measured data contained only NaN/inf entries."""


class MaskAlignmentError(StructureError):
    """The observed residues could not be aligned to the ProteinNet mask."""


class CoordsetIndexError(StructureError):
    """A ProteinNet model index exceeds the structure's coordset count
    (the reference surfaces this as IndexError -> COORDSET_INDEX_ERROR,
    proteinnet2pytorch.py:76-79, proteinnet_errors.py)."""
