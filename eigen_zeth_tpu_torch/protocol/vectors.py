"""Reference parity vectors — the canned Groth16/BN128 proof.

A copy of eigen_zeth_tpu/protocol/vectors.py's embedded values: the
reference repo's test vectors (proof/proof.json and
proof/public_input.json), which its DEBUG_PROOF fake-prover path stamps
onto every batch (src/settlement/worker.rs:49-96) and its settlement layer
parses (src/settlement/ethereum/mod.rs:445-481).  Only the embedded copies
are read: the port looks for no file outside its checkout.
"""

from __future__ import annotations

import copy

_EMBEDDED_PROOF = {
    "pi_a": {
        "x": "17417480591305158925649477501478755112960263076414890363431950352106756703156",
        "y": "3861645839258872471588434820677153286443622533258823533716073415753807193362",
    },
    "pi_b": {
        "x": [
            "1888192340250615284162548953478000113552765573288627153885483983991945077778",
            "12839537089607918006526648939966606447200305496614910310480973165133791671186",
        ],
        "y": [
            "9356128563962693123369145196078200120594297064426889980828801354429599038284",
            "8356895530159769835834895094470393417156532106130004017665561138310422920909",
        ],
    },
    "pi_c": {
        "x": "4689980742433253475969746726233113733646868104702109866973549391946972020034",
        "y": "7120799072200037615976388306327185991018815509189704120496254138703976052472",
    },
    "protocol": "groth16",
    "curve": "BN128",
}

_EMBEDDED_PUBLIC = [
    "14190879858911742134402832400201910146341202868841835779272582838585145689449"
]


def reference_proof() -> dict:
    return copy.deepcopy(_EMBEDDED_PROOF)


def reference_public_input() -> list:
    return list(_EMBEDDED_PUBLIC)
