# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: prover/v1/prover.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x16prover/v1/prover.proto\x12\tprover.v1\"\x19\n\x07Version\x12\x0e\n\x06v0_0_1\x18\x01 \x01(\t\"\x9c\x02\n\rProverRequest\x12\n\n\x02id\x18\x01 \x01(\t\x12\x31\n\nget_status\x18\x02 \x01(\x0b\x32\x1b.prover.v1.GetStatusRequestH\x00\x12:\n\x0fgen_batch_proof\x18\x03 \x01(\x0b\x32\x1f.prover.v1.GenBatchProofRequestH\x00\x12\x44\n\x14gen_aggregated_proof\x18\x04 \x01(\x0b\x32$.prover.v1.GenAggregatedProofRequestH\x00\x12:\n\x0fgen_final_proof\x18\x05 \x01(\x0b\x32\x1f.prover.v1.GenFinalProofRequestH\x00\x42\x0e\n\x0crequest_type\"\xa2\x02\n\x0eProverResponse\x12\n\n\x02id\x18\x01 \x01(\t\x12\x32\n\nget_status\x18\x02 \x01(\x0b\x32\x1c.prover.v1.GetStatusResponseH\x00\x12;\n\x0fgen_batch_proof\x18\x03 \x01(\x0b\x32 .prover.v1.GenBatchProofResponseH\x00\x12\x45\n\x14gen_aggregated_proof\x18\x04 \x01(\x0b\x32%.prover.v1.GenAggregatedProofResponseH\x00\x12;\n\x0fgen_final_proof\x18\x05 \x01(\x0b\x32 .prover.v1.GenFinalProofResponseH\x00\x42\x0f\n\rresponse_type\"\x8a\x01\n\x14GenBatchProofRequest\x12\x35\n\x10gen_batch_chunks\x18\x01 \x01(\x0b\x32\x19.prover.v1.GenBatchChunksH\x00\x12\x33\n\x0fgen_chunk_proof\x18\x02 \x01(\x0b\x32\x18.prover.v1.GenChunkProofH\x00\x42\x06\n\x04step\"k\n\x0eGenBatchChunks\x12\x10\n\x08\x62\x61tch_id\x18\x01 \x01(\t\x12\x1f\n\x05\x62\x61tch\x18\x02 \x01(\x0b\x32\x10.prover.v1.Batch\x12\x10\n\x08\x63hain_id\x18\x03 \x01(\x04\x12\x14\n\x0cprogram_name\x18\x04 \x01(\t\"\x83\x01\n\rGenChunkProof\x12\x10\n\x08\x62\x61tch_id\x18\x01 \x01(\t\x12\x0f\n\x07task_id\x18\x02 \x01(\t\x12\x13\n\x0b\x63hunk_count\x18\x03 \x01(\x04\x12\x10\n\x08\x63hain_id\x18\x04 \x01(\x04\x12\x14\n\x0cprogram_name\x18\x05 \x01(\t\x12\x12\n\nbatch_data\x18\x06 \x01(\t\"\x1d\n\x05\x42\x61tch\x12\x14\n\x0c\x62lock_number\x18\x01 \x03(\x04\"\x97\x01\n\x15GenBatchProofResponse\x12;\n\x10gen_batch_chunks\x18\x01 \x01(\x0b\x32\x1f.prover.v1.GenBatchChunksResultH\x00\x12\x39\n\x0fgen_chunk_proof\x18\x02 \x01(\x0b\x32\x1e.prover.v1.GenChunkProofResultH\x00\x42\x06\n\x04step\"\xdb\x01\n\x14GenBatchChunksResult\x12\x10\n\x08\x62\x61tch_id\x18\x01 \x01(\t\x12\x0f\n\x07task_id\x18\x02 \x01(\t\x12/\n\x0bresult_code\x18\x03 \x01(\x0e\x32\x1a.prover.v1.ProofResultCode\x12\x13\n\x0b\x63hunk_count\x18\x04 \x01(\x04\x12\x12\n\nbatch_data\x18\x05 \x01(\t\x12\x16\n\x0epre_state_root\x18\x06 \x01(\x0c\x12\x17\n\x0fpost_state_root\x18\x07 \x01(\x0c\x12\x15\n\rerror_message\x18\x08 \x01(\t\"\xb9\x01\n\x13GenChunkProofResult\x12\x10\n\x08\x62\x61tch_id\x18\x01 \x01(\t\x12\x0f\n\x07task_id\x18\x02 \x01(\t\x12/\n\x0bresult_code\x18\x03 \x01(\x0e\x32\x1a.prover.v1.ProofResultCode\x12\x37\n\x12\x62\x61tch_proof_result\x18\x04 \x01(\x0b\x32\x1b.prover.v1.BatchProofResult\x12\x15\n\rerror_message\x18\x05 \x01(\t\"P\n\x10\x42\x61tchProofResult\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12+\n\x0c\x63hunk_proofs\x18\x02 \x03(\x0b\x32\x15.prover.v1.ChunkProof\"@\n\nChunkProof\x12\x10\n\x08\x63hunk_id\x18\x01 \x01(\x04\x12\x11\n\tproof_key\x18\x03 \x01(\t\x12\r\n\x05proof\x18\x02 \x01(\t\"c\n\x19GenAggregatedProofRequest\x12\x10\n\x08\x62\x61tch_id\x18\x01 \x01(\t\x12\x19\n\x11recursive_proof_1\x18\x02 \x01(\t\x12\x19\n\x11recursive_proof_2\x18\x03 \x01(\t\"\x8d\x01\n\x1aGenAggregatedProofResponse\x12\x10\n\x08\x62\x61tch_id\x18\x01 \x01(\t\x12/\n\x0bresult_code\x18\x02 \x01(\x0e\x32\x1a.prover.v1.ProofResultCode\x12\x15\n\rresult_string\x18\x03 \x01(\t\x12\x15\n\rerror_message\x18\x04 \x01(\t\"n\n\x14GenFinalProofRequest\x12\x10\n\x08\x62\x61tch_id\x18\x01 \x01(\t\x12\x17\n\x0frecursive_proof\x18\x02 \x01(\t\x12\x12\n\ncurve_name\x18\x03 \x01(\t\x12\x17\n\x0f\x61ggregator_addr\x18\x04 \x01(\t\"\xb4\x01\n\x15GenFinalProofResponse\x12\x10\n\x08\x62\x61tch_id\x18\x01 \x01(\t\x12/\n\x0bresult_code\x18\x02 \x01(\x0e\x32\x1a.prover.v1.ProofResultCode\x12\x15\n\rresult_string\x18\x03 \x01(\t\x12*\n\x0b\x66inal_proof\x18\x04 \x01(\x0b\x32\x15.prover.v1.FinalProof\x12\x15\n\rerror_message\x18\x05 \x01(\t\"1\n\nFinalProof\x12\r\n\x05proof\x18\x01 \x01(\t\x12\x14\n\x0cpublic_input\x18\x02 \x01(\t\"\x12\n\x10GetStatusRequest\"\xbe\x02\n\x11GetStatusResponse\x12\n\n\x02id\x18\x01 \x01(\t\x12\x33\n\x0bresult_code\x18\x02 \x01(\x0e\x32\x1e.prover.v1.GetStatusResultCode\x12\x33\n\x06status\x18\x03 \x01(\x0e\x32#.prover.v1.GetStatusResponse.Status\x12.\n\rprover_status\x18\x04 \x01(\x0b\x32\x17.prover.v1.ProverStatus\x12\x15\n\rerror_message\x18\x05 \x01(\t\"l\n\x06Status\x12\x16\n\x12STATUS_UNSPECIFIED\x10\x00\x12\x12\n\x0eSTATUS_BOOTING\x10\x01\x12\x14\n\x10STATUS_COMPUTING\x10\x02\x12\x0f\n\x0bSTATUS_IDLE\x10\x03\x12\x0f\n\x0bSTATUS_HALT\x10\x04\"\xeb\x02\n\x0cProverStatus\x12 \n\x18last_computed_request_id\x18\x02 \x01(\t\x12\x1e\n\x16last_computed_end_time\x18\x03 \x01(\x04\x12$\n\x1c\x63urrent_computing_request_id\x18\x04 \x01(\t\x12$\n\x1c\x63urrent_computing_start_time\x18\x05 \x01(\x04\x12\x15\n\rversion_proto\x18\x06 \x01(\t\x12\x16\n\x0eversion_server\x18\x07 \x01(\t\x12!\n\x19pending_request_queue_ids\x18\x08 \x03(\t\x12\x13\n\x0bprover_name\x18\t \x01(\t\x12\x11\n\tprover_id\x18\n \x01(\t\x12\x17\n\x0fnumber_of_cores\x18\x0b \x01(\x04\x12\x14\n\x0ctotal_memory\x18\x0c \x01(\x04\x12\x13\n\x0b\x66ree_memory\x18\r \x01(\x04\x12\x0f\n\x07\x66ork_id\x18\x0e \x01(\x04*8\n\x0fProofResultCode\x12\x10\n\x0c\x43OMPLETED_OK\x10\x00\x12\x13\n\x0f\x43OMPLETED_ERROR\x10\x01*\'\n\x13GetStatusResultCode\x12\x06\n\x02OK\x10\x00\x12\x08\n\x04\x46\x41IL\x10\x01\x32Z\n\rProverService\x12I\n\x0cProverStream\x12\x18.prover.v1.ProverRequest\x1a\x19.prover.v1.ProverResponse\"\x00(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'prover.v1.prover_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PROOFRESULTCODE._serialized_start=3069
  _PROOFRESULTCODE._serialized_end=3125
  _GETSTATUSRESULTCODE._serialized_start=3127
  _GETSTATUSRESULTCODE._serialized_end=3166
  _VERSION._serialized_start=37
  _VERSION._serialized_end=62
  _PROVERREQUEST._serialized_start=65
  _PROVERREQUEST._serialized_end=349
  _PROVERRESPONSE._serialized_start=352
  _PROVERRESPONSE._serialized_end=642
  _GENBATCHPROOFREQUEST._serialized_start=645
  _GENBATCHPROOFREQUEST._serialized_end=783
  _GENBATCHCHUNKS._serialized_start=785
  _GENBATCHCHUNKS._serialized_end=892
  _GENCHUNKPROOF._serialized_start=895
  _GENCHUNKPROOF._serialized_end=1026
  _BATCH._serialized_start=1028
  _BATCH._serialized_end=1057
  _GENBATCHPROOFRESPONSE._serialized_start=1060
  _GENBATCHPROOFRESPONSE._serialized_end=1211
  _GENBATCHCHUNKSRESULT._serialized_start=1214
  _GENBATCHCHUNKSRESULT._serialized_end=1433
  _GENCHUNKPROOFRESULT._serialized_start=1436
  _GENCHUNKPROOFRESULT._serialized_end=1621
  _BATCHPROOFRESULT._serialized_start=1623
  _BATCHPROOFRESULT._serialized_end=1703
  _CHUNKPROOF._serialized_start=1705
  _CHUNKPROOF._serialized_end=1769
  _GENAGGREGATEDPROOFREQUEST._serialized_start=1771
  _GENAGGREGATEDPROOFREQUEST._serialized_end=1870
  _GENAGGREGATEDPROOFRESPONSE._serialized_start=1873
  _GENAGGREGATEDPROOFRESPONSE._serialized_end=2014
  _GENFINALPROOFREQUEST._serialized_start=2016
  _GENFINALPROOFREQUEST._serialized_end=2126
  _GENFINALPROOFRESPONSE._serialized_start=2129
  _GENFINALPROOFRESPONSE._serialized_end=2309
  _FINALPROOF._serialized_start=2311
  _FINALPROOF._serialized_end=2360
  _GETSTATUSREQUEST._serialized_start=2362
  _GETSTATUSREQUEST._serialized_end=2380
  _GETSTATUSRESPONSE._serialized_start=2383
  _GETSTATUSRESPONSE._serialized_end=2701
  _GETSTATUSRESPONSE_STATUS._serialized_start=2593
  _GETSTATUSRESPONSE_STATUS._serialized_end=2701
  _PROVERSTATUS._serialized_start=2704
  _PROVERSTATUS._serialized_end=3067
  _PROVERSERVICE._serialized_start=3168
  _PROVERSERVICE._serialized_end=3258
# @@protoc_insertion_point(module_scope)
