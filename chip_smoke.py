"""Chip smoke for tpucap_torch: drives the port's serving and training
paths on one NVIDIA GPU and holds every hand-written kernel against its
plain version.

    python3 chip_smoke.py    # from the repo root; needs one CUDA card, nvcc and g++

Phases (any failure ends the run with a non-zero exit and no result line):

1. the card's name and power limit (``nvidia-smi``); the host's g++, CPU
   count and whether libjpeg and PIL are present (logged only: the port
   uses neither); then the kernel build from ``tpucap_torch/csrc`` (nvcc)
   beside the JPEG decoder's (g++), and its time;
2. each kernel against its plain PyTorch version on the card at the main
   paths' shapes, in f32 (TF32 off) and bf16, with the stated tolerances
   (K2 and K3 in f32 also at the f32 decodes' rows: fit's monitor's 256,
   phase 8's caption's 24 and its evaluate's and monitor's 64; in both
   dtypes at the continuous engine's 64 and 192 rows, phase 15, and at
   phase 16's dialled rows: 64 priming, 192 continuing, 384, 768 and 3072
   constrained at C = 1, 2, 4; at phase 18's 320, 576 and 960 rows; in
   f32 at phase 17's 4096-row draw);
   CUDA-event times of the kernel, the plain version and, where one PyTorch
   call computes the same function, that call; the least time the card
   could take (bound) from the bytes and operations of these inputs. K4
   (the fused identity block) at each of ResNet-50's four stage shapes,
   beside the port's unfused block (three cuDNN convs and their
   elementwise passes); K5 (flash attention) at ViT-B/16's shape, beside
   ``F.scaled_dot_product_attention``. K1 is also checked from 300 x 250
   to 224 and to 299 (rows that fill no whole 16-byte chunk), at the same
   size with a pixel count that is no multiple of 8, and from a source
   that is not 8-byte aligned; K2 at a ragged batch (111 rows, E = 512,
   U = 256), K3's merge head at 111 rows and its projection at 111 rows
   and a vocabulary of 1001, K4 at (3, 13, 11, 256) with M = 64 (no tile
   divides the image, odd batch) and at (3, 7, 7, 2048) with M = 512, K5
   at L = 49 and L = 257 with 4 heads. Each kernel's line ends with its
   share of its bound (bound_ms / ms) and its time over the library call's;
2d. K5's two backward kernels (dK/dV and dQ) and K5's row-statistics
   output against their plain versions, f32 and bf16, at ViT-B/16's
   training shape (batch 64, L 196, 12 heads) and at L = 49 and 257 with 4
   heads, every element of a NaN-filled gradient buffer written; in bf16
   at the training shape, two launches of each kernel give identical bits;
   times beside the plain versions, the backward of
   ``F.scaled_dot_product_attention`` (forward + backward, less the
   forward) and the bound, with each kernel's registers a thread, shared
   memory a block and blocks an SM (``cudaFuncGetAttributes``);
3. the slice at full width: uint8 (256, 224, 224, 3) -> K1 -> ResNet-50
   (BN folded) -> lstm1 merge decoder (embed/hidden 256, vocab 7579) ->
   beam 3, max_len 34, bf16, random weights from a seed; launch counters
   reset just before and read just after one batch; captions/s, ms per
   decode step and a few captions;
3b. path A, the same with ``fused_blocks=True``: ResNet-50's 12 identity
   blocks as K4 (12 launches per batch);
3c. path B: ViT-B/16 at 224 (tf mode, 12 x 768, 12 heads, MLP 3072,
   pooled 768-d) with ``attention_impl="flash"`` (K5, 12 launches per
   batch), then the same decoder and beam search;
4. kernel path against plain path on the card in f32 at batch 32: the
   first decode step's logits within tolerance, and the share of captions
   that agree (random weights leave near-ties, so not all must);
4b. in f32 at batch 32: fused-block against unfused ResNet-50 features,
   ViT flash against ViT xla features, each within tolerance, and the share
   of identical captions on each path; in bf16, the fused blocks against
   the unfused ones, one block and the whole encoder;
5. training at full width: (a) ``make_train_step`` at ``bench.py --mode
   train``'s shapes (lstm1, batch 256, T 34 + 1, vocab 7579, bf16 compute,
   f32 masters; no kernel launches: the teacher-forced loop is plain), step
   ms and samples/s; (b) ``fit_finetune`` with ViT-B/16 at 224 and flash
   attention, lstm1, vocab 7579, batch 64, f32 and bf16: counters reset
   just before and read just after, 12 launches each of K5 forward, dK/dV
   and dQ per step, loss descending over repeated steps on one batch, step
   ms, images/s, peak memory; (c) f32, one joint step's loss and gradients
   with the kernels against the same with ``attention_impl="xla"``;
6. JPEG files to captions: (b) the port's own JPEG decoder, built on this
   machine, decodes the committed fixtures (``tests/data/torch_jpeg/``:
   six baseline, one progressive, a 4:1:1 and a 4:4:0) to the SHA-256
   digests that tpucap's libjpeg decode recorded, at their own size and at
   224 with ``fast_scale`` False (8/8) and True (tpucap's default, 5/8);
   (c) path A (fused blocks, bf16) through ``caption_dataset(paths)`` at
   the default ``fast_scale=True``, then with ``fast_scale=False``, on 1024
   paths (the six baseline fixtures tiled, four batches of 256 from
   500 x 375 and 375 x 500 photos), counters reset just before and read
   just after: K1 once a batch (its same-size route: the host resizes), K2
   and K3 once a decode step, K4 12 times a batch, the same launches and
   the same captions as ``caption_batch`` on the same decoded batches;
   (d) the host decoder's images/s at one thread and at the default for
   both settings, on the baseline batch and on a progressive one,
   captions/s of ``caption_dataset`` against ``caption_batch`` on decoded
   batches, and the share of the decode time the loader's overlap hides;
7. bundle and evaluation, on a fresh path-3 pipeline (lstm1, beam 3,
   vocab 7579, bf16, 2048-d random features from seeds, references drawn
   from the vocabulary): (a) ``evaluate`` on 1000 images with 5 references
   each at batch 256 (four decode batches, the last padded), every metric
   family, the captions equal to ``generate``'s on the same batches, K2 and
   K3 34 + 34 launches a batch, every score finite, BLEU, ROUGE-L and
   METEOR in [0, 1]; the decode's seconds, the metrics' host seconds and
   captions/s; (b) ``save``, ``load`` on the card, every param leaf bit for
   bit with its dtype and the captions of a batch the same,
   ``reload_params`` from the bundle, a bundle with another vocabulary
   refused and the live captions unchanged; (c) ``fit(val_data=...)`` at
   batch 256, bf16 compute, 2048 training and 512 validation rows, 3
   epochs, ``val_metric="bleu4"``, patience 1: each epoch's val_loss,
   val_bleu4 and seconds, the validation's seconds, and the launches of
   the monitor's greedy decode (K2 and K3; the training is plain); that
   decode's route (f32, 256 rows, beam 1) step by step against the plain
   step's logits;
8. the CLI workflow on CONFIG_1 (``--preset config1``: VGG16 fc2 4096-d
   features at 224, lstm1 embed/hidden 256, max_len 34), in-process through
   ``tpucap_torch.cli.main.main`` in a temporary directory that holds a
   Flickr8k-format dataset written here: the six baseline fixtures linked
   under 512 ids, a token file of 5 captions an image from ``corpus``
   (vocabulary 7579), train / dev / test splits of 384 / 64 / 64 ids.
   (a) ``extract`` at batch 32: 512 rows, bit for bit
   ``extract_features`` of the same weights, no kernel launched (the host
   preprocesses), images/s; (b) ``train`` with the dev split, the bleu4
   monitor, patience 1, 3 epochs at batch 64 and ``--metrics-log``: the
   steps saved (30 an epoch), the steps kept and the best step those
   orbax's rules give for the logged val_bleu4 values, every kept step
   restored bit for bit as saved, seconds an epoch, the monitor's K2 and K3
   launches; on the best step's params, the f32 decode route (K2, K3)
   step by step against the plain step's logits at caption's 24 rows and
   evaluate's 64; (c) ``caption`` of 8 images with tpucap's default beam 3: the
   lines of ``caption_images`` on a pipeline restored from the same best
   step, K2 and K3 once + once a decode step; (d) ``evaluate`` of the test
   split with every metric and ``--coco-results``: ``pipe.evaluate``'s
   scores on the same params, finite, BLEU, ROUGE-L and METEOR in [0, 1],
   the decode's and the metrics' seconds; (e) ``export --format aot`` exits
   non-zero before any restore;
9. the other presets at their published widths (embed and hidden 256,
   vocab 7579, max_len 34, attention_dim 256), random weights from the
   config seed, BN folded: (a) CONFIG_2's ``caption_batch`` of 256 uint8
   images at 299 (K1 in tf mode, InceptionV3 pooled, lstm1, beam 3; the
   preset's "mixed" keeps the params f32, so K2's f32 kernel and K3's f32
   routes at 768 rows), K1 once and K2 and K3 once a step, the decode's
   wall; then with ``no_repeat_ngram_size=3``, greedy and beam: no caption
   holds a repeated trigram, K2 and K3 still launch every step; for each of
   the three, the fused step against the plain one with TF32 off (logits
   within 1e-4 + 1e-5 rel at every step along the fused decode; tokens
   equal on every image whose plain decode met no near-tie within that
   tolerance); the ban's device time a step; (b) ``--decoder inject`` on
   those features, one beam-3 ``generate`` (plain step, no kernel); (c)
   CONFIG_4's ``caption_batch`` of 64 images at 224 (K1 in caffe mode,
   VGG16's 14 x 14 x 512 grid, the attention decoder, beam 3, plain step),
   ``features`` and ``att_feat`` (64, 196, .) inside every step of the beam,
   then ``fit`` on spatial features at ``attention_reg=1.0`` (4 steps of
   64), the reg metric logged; (d) CONFIG_5's ``fit`` on 2048-d features,
   2 epochs of 8 steps at its batch 256, each epoch's loss and seconds.
   K1 is also checked in phase 2 at (256, 299, 299, 3) in tf mode;
10. fine-tuning's dials, with torch's deterministic settings on in this
   process for the phase only (logged): (a) one joint step (ViT-B/16
   flash + lstm1, batch 64, bf16, dropout off) from one state in four
   settings: plain, ``remat_encoder``, ``grad_accum_steps=2``, augmented
   (flip and a 16-pixel shift); launches a step (K5, dK/dV, dQ: 12/12/12,
   24/12/12, 24/24/24, 12/12/12), remat's params equal plain's bit for
   bit, peak memory and step ms (median of 5) of each, the augmentation's
   own ms, and accumulation's gradients against plain's in f32 (each step
   under plain SGD at lr 1e6, the gradient read back from the update;
   within 1e-4 of each tensor's scale); (b) ``train --finetune-encoder
   --preset config1`` (VGG16 at 224 + lstm1, f32) with ``--augment
   --augment-shift 8 --remat-encoder --grad-accum-steps 2
   --checkpoint-every-steps 4 --handle-preemption``, 2 epochs on phase
   8's dataset with its training split cut to 128 ids, three times in
   this process: uninterrupted; cut by a SIGTERM that a watcher thread
   sends once the first interval checkpoint appears (the preempted
   lines, the rescue the manager's latest step, without metrics);
   ``--resume`` from it (the resumed position printed); the resumed
   bundle's params equal the uninterrupted one's bit for bit; each run's
   wall, step ms, epoch spans, peak memory, save and restore s; then
   ``CaptioningPipeline.load`` of that bundle captions the 64 test images
   (K2 and K3 once a step) and its f32 decode route is held step by step
   to the plain step at those rows;
11. EMA, checkpoint averaging and the optimizer surface: (a) ``fit`` at
   batch 256, bf16 compute, 2048 rows of 2048-d features, 2 epochs,
   ``grad_accum_steps=2``, val_metric cider on 512 rows, a checkpoint
   manager, without EMA, with ``ema_decay=0.999`` and with it again while
   each step's params are copied to the host (torch's deterministic
   settings on): the params equal without and with EMA bit for bit, the
   shadow equals the host's f32 recurrence d e + (1 - d) p bit for bit,
   the EMA update's device ms, the peak memory with and without; then
   ``use_ema_weights`` and a greedy ``generate`` of 256 rows (K2, K3 once a
   step) and ``use_averaged_weights(last_k=2)`` within 1e-6 of each
   tensor's scale of the numpy mean of the two restored checkpoints; (b)
   ``make_train_step`` at phase 5(a)'s shapes, 12 steps each: plain sgd
   under constant, cosine (10 warmup steps) and exponential decay, each
   update -lr(step) g bit for bit with lr(step) on the card within one
   ulp of the base lr of the host's f32 schedule; sgd with momentum 0.9
   under cosine with warmup, rmsprop with exponential decay, adagrad and
   adamw with cosine: finite losses, step ms, the optimizer state saved and
   restored bit for bit; (c) ``fit_finetune`` (ViT-B/16 flash + lstm1,
   batch 64, bf16, adamw under cosine with warmup, 4 steps) without and
   with ``ema_decay=0.999``: 12 launches each of K5, dK/dV and dQ a step,
   the shadow of both trees, the peak memory of each; ``use_ema_weights``
   and ``caption_batch`` of 64 uint8 images (K1 once, K5 12 times, K2 and
   K3 once a step); (d) the CLI on phase 8's dataset: ``extract``, ``train
   --ema-decay 0.999 --optimizer sgd --momentum 0.9 --lr-schedule cosine
   --warmup-steps 10`` writes ``bundle_ema``, whose
   ``CaptioningPipeline.load`` captions 8 images (K2, K3 once a step);
   ``evaluate --average-last 2`` with the same optimizer flags gives the
   scores of ``use_averaged_weights`` and ``evaluate``;
12. scheduled sampling, steps_per_dispatch, frozen pretrained embeddings,
   ``score`` and ``compare``: (a) ``make_train_step`` at phase 5(a)'s
   shapes (bf16, dropout off, torch's deterministic settings on): eps 0 the
   plain step's update bit for bit, at eps 1 the mixed inputs those of a
   host recomputation from pass 1's argmax and the mixing rules, pass 1's
   tokens that bf16 compute changes against f32, step ms with scheduled
   sampling off and on; then ``fit`` at bf16 with ``scheduled_sampling=0.5``
   (linear, 3 epochs, the cider monitor): ss_eps 0, 0.25, 0.5, K2 and K3
   once a monitor step; (b) ``fit`` over 2 epochs of 10 steps at
   ``steps_per_dispatch`` 1, 4 and 8 with a checkpoint every 5 steps
   (deterministic settings on): params bit for bit spd 1's, epoch losses
   within 1e-6 relative, the steps saved those of tpucap's rule (spd 4: 8,
   14, 18; spd 8: 8, 18; epochs at 10, 20), each run's ms a step; (c) a
   GloVe-format file of random 256-d vectors (every other word, and 5
   outside the vocabulary), ``set_pretrained_embeddings(freeze=True)``,
   ``fit`` with adamw at weight decay 0.01: the table bit for bit, every
   other subtree moved, the checkpoint restored into a template without the
   freeze; ``fit_finetune`` (ViT-B/16 flash + lstm1, batch 64, bf16, 2
   steps) with the frozen table: the table bit for bit, K5, dK/dV and dQ 12
   times a step; (d) on (a)'s trained decoder, 256 rows:
   ``score_captions`` of the greedy captions against the greedy engine's
   score (K2, K3) within 1e-4 at f32 (TF32 off), at bf16 reported, the rows
   that did not end left out and counted; ``score_captions``' ms; (e) the
   CLI on phase 8's dataset: ``train --scheduled-sampling 0.5 --ss-schedule
   inv_sigmoid --steps-per-dispatch 4 --embeddings FILE --freeze-embeddings``
   (every checkpoint's table the file's matrix), ``score --image`` of 8
   images with ``--captions-file`` (tpucap's line for each, those of
   ``score_captions`` on the restored pipeline; no kernel: the images are
   preprocessed on the host as tpucap's ``extract_features`` does them),
   ``evaluate --dump-captions --average-last`` 1 and 2 (K2, K3), ``compare
   --metric cider`` of the two dumps (its JSON ``compare_caption_files``');
13. streamed training input and LoRA, under torch's deterministic
   settings: (a) Flickr8k's train split (6000 ids x 5 captions, pooled
   2048-d f32 rows written uncompressed by ``np.savez``, about 49 MB),
   lstm1, vocab 7579, batch 256, bf16, dropout on, one epoch of 117 steps:
   ``fit(stream=True)`` on the lazy ``np.load`` handle against
   ``fit(stream=False)``, params and history bit for bit; each call's host
   peak (tracemalloc, runs of their own) and ms a step; a streamed run cut
   by a guard after step 50 and resumed: the uncut streamed params bit for
   bit; the stream at steps_per_dispatch 4: spd 1's params bit for bit;
   (b) ``fit_lora`` (rank 8) at the same widths on 2048 rows, 2 epochs:
   the first step's loss the base model's, the base tree bit for bit after
   the fit, every adapter moved, the logged trainable share
   ``lora_param_counts``', greedy of 256 rows on the merged decoder equal
   to greedy on ``apply_lora``'s view (K2 = K3 once a step), ms a step
   beside ``fit``'s, ``save_lora`` then ``apply_lora_file`` into a fresh
   pipeline bit for bit and the artifact's size; (c)
   ``fit_finetune(lora_rank=8)`` on ViT-B/16 flash at 224 + lstm1, batch
   64, f32 and bf16, 4 steps on one batch: 12 launches each of K5, dK/dV
   and dQ a step, the loss descending, the base bit for bit, ms a step and
   peak memory; with ``freeze_encoder=True`` no adapter under the encoder
   (K5 forward only); (d) the CLI on phase 8's dataset: ``train
   --lora-rank 8 --lora-out FILE`` (its bundle's decoder the config seed's
   merged with the artifact, bit for bit), ``CaptioningPipeline.load`` of
   that bundle captions 8 images (K2 = K3 once a step), ``train
   --stream-features`` writes ``train``'s bundle bit for bit, and
   ``--lora-rank`` with ``--stream-features`` exits with tpucap's message;
14. Keras ``.h5`` import and export through the port's own HDF5 reader
   and writer (the card's host has no h5py, TensorFlow or Keras; the
   encoder files are written here in Keras's layout, each layer's class
   and the config keys the importers read in ``model_config``): VGG16 fc2
   (with its 1000-way head, about 553 MB), ResNet-50 and InceptionV3
   (Keras's auto-names, a seeded order that is not their creation order),
   each at full width from a seed with seeded BatchNorm statistics,
   written, read back (time and MiB/s of a warm read) and imported bit for
   bit; (a) on phase 8's dataset, ``extract --preset config1 --keras-h5``
   bit for bit ``extract_features`` of a pipeline given the tree directly,
   ``train`` one epoch, ``caption --keras-h5`` and ``score --keras-h5`` the
   lines of the direct route on the same step (K2 and K3 once a step);
   (b) the ResNet-50 file in path A (BN folded, ``fused_blocks``, K4 12
   times) and the InceptionV3 file in CONFIG_2's encoder at 299: features
   and captions those of the tree installed directly, bit for bit; (c)
   ``export`` of (a)'s trained merge decoder, ``export_h5`` of CONFIG_2's
   inject decoder and CONFIG_4's attention decoder (196 positions), each
   file re-imported: params bit for bit, greedy and beam token for token
   with the same launches; (d) ``train --finetune-encoder --keras-h5`` on
   13 training ids under torch's deterministic settings: its loss that of
   ``fit_finetune`` with the tree installed directly, bit for bit;
15. serving: path A (ResNet-50 BN folded with ``fused_blocks``, lstm1,
   vocab 7579, beam 3, max_len 34) behind ``CaptionHTTPServer`` on
   127.0.0.1, port 0, ``max_batch`` 64, ``max_delay_ms`` 5, in bf16 as the
   default model and in f32 as an extra model, every request through the
   port's ``CaptionClient``: (a) ``warmup()`` of buckets 1-64, each server
   timed; (b) the f32 model's ``/caption_batch`` of 64 feature rows and of
   64 JPEGs token for token ``generate``'s and the offline route's, each
   baseline fixture's ``/caption`` (bf16) the offline route's at bucket 1
   (the port's host decode, ``preprocess_input``, ``encode_images``,
   ``generate``); (c) closed-loop load from a client process of its own:
   ``/caption_features`` single rows from 1, 16 and 64 threads, 64 again at
   ``pipeline_depth`` 2, ``/caption`` JPEGs from 16 threads, 5 s each:
   captions/s, client p50 and p99, the server's mean batch, the buckets and
   the host ms a dispatch, beside the offline ``generate`` rate at 64 rows;
   every request answered 200; (e) the bf16 model under load from 16
   threads while the f32 model's two batches run 20 times: every f32 reply
   (b)'s, and every read of the TF32 flags inside the f32 model's encodes
   and decode steps finds them off; (d) ``/reload`` of the f32 model to a
   bundle of another seed (the first that changes every row's caption)
   while one client sends its 64 rows in a loop: every reply the old
   captions or the new, whole, and every request sent after the answer the
   new; K2, K3 and K4 counted over (b)-(e), K1 and K5 not launched; then
   the continuous engine (``engine="continuous"``, 64 slots, 8 ticks a
   sync group; one HTTP server each for the f32 model greedy and at beam 3
   and the bf16 model at beam 3, built before (b), so their engines keep
   the params of then), warmed up with the others in (a): (f) the f32
   model's 64 rows and 64 JPEGs (images mode: K4 on each admission wave),
   greedy and beam 3, in one ``/caption_batch`` and as 64 single requests
   2 ms apart, token for token ``generate``'s and the offline route's (a
   difference is reported with its logit gap); (g) (c)'s closed loops on
   the bf16 model, and ``/caption_stream_features`` from 16 threads
   (every stream's spans join to its caption): captions/s, p50 / p99, the
   first span's p50 / p99, ticks, mean occupancy, ms a sync group; (h)
   (d)'s ``/reload`` under load on the f32 beam server; over (f)-(h) K2 and
   K3's two kernels once a served tick and K4 12 times a served images
   admission wave, nothing else;
16. the per-request dials: path A (ResNet-50 BN folded with
   ``fused_blocks``, lstm1, vocab 7579, beam 3, max_len 34) in f32, 64 rows
   of 2048-d features from a seed: (a) ``generate_continuation``, greedy
   and beam 3, prefixes of 0, 1, 3 and 5 vocabulary words in turn (P
   padded to 8): captions token for token the plain step path's (a
   difference is a fault reported with its logit gap), each opening with
   its prefix, 8 priming steps a call, the empty prefix ``generate``'s; ms
   a call and the priming's ms; (b) ``generate_constrained(return_details=
   True)`` at C = 1, 2 and 4, every row its own words: captions and
   satisfied words the plain path's, scores within P16_SCORE_ATOL; the
   satisfaction rate; ms a decode and a step beside unconstrained beam 3;
   (c) the model behind ``CaptionHTTPServer`` (batch engine): one
   ``/caption_batch`` of the 64 rows, a third plain, a third prefixed, a
   third constrained at C = 2 (per-row dials), token for token the offline
   calls on the same rows, and each baseline fixture's ``/caption?prefix=``
   or ``?include_words=`` (images mode, K4) the offline route's at bucket
   1; (d) 5 s closed loops from 16 client threads, plain and with a third
   of the requests prefixed and a third constrained: captions/s, p50 and
   p99; one launch window over (a)-(d): K2 and K3's two kernels once a
   counted step (priming and decode, offline and served; the plain paths
   launch nothing), K4 12 times a counted encoder pass, nothing else;
17. the tools and the sampler: path A (as phase 16) at 64 rows in f32
   and bf16: (a) f32 sampling at top_k = 1 is greedy's captions; (b) one
   seed twice gives the same tokens, lengths and score bits, in both
   dtypes; (c) f32, the kernel path on a set of Gumbel draws against the
   plain step path on the same draws, a differing row reported with its
   perturbed logit gap (a fault unless a near-tie); (d) 4096 draws of the
   first token at temperature 1 (the head's bias drawn with std 2, so the
   distribution is not flat) against the plain step's softmax, chi-square
   over the 16 likeliest words and the pooled rest within P17_CHI2_BOUND;
   (e) ``generate_n_best`` entry 0 is ``generate(beam)`` at beam 3; (f) a
   sampling ``CaptionServer`` in images mode gives ``generate(method=
   "sample")`` of the same batch (K4); (j) ms a step of sampling against
   greedy's, with and without top-p (bf16); one launch window over them:
   K2 and K3 once a counted step, K4 12 times an encoder pass, nothing
   else; then (g) ``python -m tpucap_torch doctor`` and ``profile
   --workload decode|train|encoder`` (and ``--encoder vit_b16``, its route
   logged) as subprocesses side by side, each trace holding 3
   ``profile_step`` ranges and kernel events, the decode trace K2's and K3's
   kernels; (h) ``train --tensorboard-dir`` on phase 8's dataset read back
   with ``read_scalars`` as the logged records;
18. the rest of the decode toolkit: path A (as phase 16) at 64 rows in
   f32, seeds 0 and 1, and CONFIG_4 (VGG16's 14 x 14 grid, the attention
   decoder) in f32: (a) diverse search at G = 1 is beam 3 (captions and
   scores), and at diversity 0 every group of G = 3 is beam 3's but for
   rows parted at a near-tie (counted; at most 8 of 64), with one step's
   logits and logsumexp of one hypothesis in two rows compared bit for
   bit;
   (b) G = 3, k' = 3, diversity 0.5
   (576 rows a step) token for token the plain step path's group by group,
   normalized scores within P16_SCORE_ATOL, the rows whose group-0 and
   group-1 captions differ counted; (c)-(e) token for token but for at
   most 8 of 64 rows parted at a near-tie (logged, with the f32 logit gap
   where one model decodes both): (c) a one-member ensemble against
   ``generate``, greedy and beam 3; (d) seeds 0 + 1 against the plain step
   path, weights [1, 0] against member 0's ``generate``; (e) path A's
   lstm1 with CONFIG_4's attention decoder on one batch of 64 uint8 images,
   each member through its own encoder (K1 both, K4 on path A), against
   the plain step path; (f) ``generate_mbr`` from sample, beam and
   diverse pools of 5: each pick in its pool and ``mbr_select``'s; (g)
   ``generate_with_attention`` greedy on CONFIG_4: the teacher-forced maps
   within P18_ALPHA_ATOL of a ``_step_full`` replay of the decode for t <
   length, each summing to 1; (j) bf16 ms a step of diverse 3 x 3 against
   beam 9 and of a two-member ensemble against one model, and ms a
   ``generate_mbr`` call a source; one launch window over them: K2 and K3
   once a counted step of each lstm1 member, K4 12 times a path-A encoder
   pass, K1 once an image batch, nothing else; then (h) ``caption --method
   diverse``, ``--method mbr --mbr-from beam`` and ``--ensemble-with`` on
   phase 8's checkpoint (and a bundle of it) print the library calls'
   lines, and ``--dump-attention`` on CONFIG_4 saved as a checkpoint writes
   tpucap's keys and dtypes, as subprocesses side by side;
19. the GRU and adaptive decoders (plain steps, as tpucap's are plain
   XLA): (a) path A into gru1, then gru2 (embed and hidden 256, vocab
   7579, beam 3, max_len 34, bf16): one batch of 256 with the counters
   reset just before and read just after, K1 1, K4 12, K2 and K3 0,
   captions/s and ms a decode step; (b) f32, 32 rows: gru1's first-step
   logits on the card within P19_LOGIT_ATOL of the same step on the CPU,
   then greedy decodes on both, rows parted at a near-tie logged, more
   than 8 of 32 fail; (c) CONFIG_4's encoder (VGG16's 14 x 14 x 512 grid
   at 224, caffe) into the adaptive decoder (embed, hidden and attention
   256), beam 3, bf16, 64 images: K1 once and nothing else, ``val`` and
   ``att_feat`` (64, 196, 256) inside every step; in f32 its
   ``generate_with_attention`` beam maps (64, 34, 197), every row summing
   to 1 within P18_ALPHA_ATOL, column 196 (beta) in [0, 1]; (d)
   ``make_train_step`` for gru1 at bench.py --mode train's shapes (batch
   256, T 35, bf16 compute) and for the adaptive decoder with
   ``attention_reg=1.0`` at batch 64 on the 196-cell grid: step ms, no
   launch, the loss falling over 5 steps on one batch; (e) a
   ``CaptionHTTPServer`` on (a)'s gru1 pipeline answers four batches of 16
   feature rows with ``generate``'s captions; (f) gru1 and gru2 through
   ``export_h5`` and ``gru_merge_decoder_params_from_keras`` bit for bit,
   their greedy and beam decodes token for token;
20. a ``{"kernels": [...]}`` line (its launches: phase 3's batch plus
   phase 9's counted serving runs for K1, K2 and K3, phase 10's counted
   steps and caption, phase 11's counted fits, decodes and commands,
   phase 12's counted monitor, joint fit, decodes and evaluates,
   phase 13's counted decodes, joint LoRA fits and caption, phase
   14's counted caption, path-A batch and re-imported decodes, phase
   15's counted serving, phase 16's, 17's and 18's windows, phase 19's
   counted batches), then ``{"ok": true, "device": {...}}`` as the last
   line.

It imports torch and tpucap_torch only (no jax, nothing of tpucap).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# FLOP/s by operand type (f32 without tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

BATCH, BEAM, MAX_LEN, VOCAB, WIDTH, IMAGE = 256, 3, 34, 7579, 256, 224
AGREE_BATCH = 32

# Where each kernel's TPU counterpart calls pl.pallas_call.
REPLACES = {
    "preprocess_u8": "tpucap/ops/preprocess.py:84",
    "lstm_cell": "tpucap/ops/pallas/lstm_step.py:64",
    "merge_head": "tpucap/ops/pallas/decoder_step.py:101",
    "vocab_proj": "tpucap/ops/pallas/decoder_step.py:101",
    "identity_block": "tpucap/ops/pallas/bottleneck.py:145",
    "flash_attention": "tpucap/models/encoders/vit.py:78",
    # jax 0.9.0's stock TPU flash attention, reached from vit.py:78 when
    # tpucap's joint fine-tuning differentiates it.
    "flash_attention_bwd_dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
    "flash_attention_bwd_dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
}
SOURCES = {
    "preprocess_u8": "tpucap_torch/csrc/preprocess.cu",
    "lstm_cell": "tpucap_torch/csrc/lstm_step.cu",
    "merge_head": "tpucap_torch/csrc/decoder_step.cu",
    "vocab_proj": "tpucap_torch/csrc/decoder_step.cu",
    "identity_block": "tpucap_torch/csrc/bottleneck.cu",
    "flash_attention": "tpucap_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkv": "tpucap_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dq": "tpucap_torch/csrc/flash_attention_bwd.cu",
}
# ResNet-50's identity-block shapes at 224: (stage, H = W, C, M, blocks).
STAGES = (
    ("conv2", 56, 256, 64, 2),
    ("conv3", 28, 512, 128, 3),
    ("conv4", 14, 1024, 256, 5),
    ("conv5", 7, 2048, 512, 2),
)
K4_F32_BATCH = 8
# K4 also where no tile divides the image and the batch is odd, and at
# conv5's widths on a small batch: (label, B, H, W, C, M).
K4_RAGGED = (("ragged", 3, 13, 11, 256, 64), ("conv5 B=3", 3, 7, 7, 2048, 512))
# ViT-B/16 at 224: tokens, heads, head width.
VIT_L, VIT_HEADS, VIT_D = 196, 12, 64
# Training: the joint step's image batch (TrainConfig.batch_size's
# default), its steps on one batch, and the decoder step's batch and
# feature width (bench.py --mode train: batch 256, ResNet-50's 2048).
TRAIN_BATCH, TRAIN_STEPS, DEC_TRAIN_BATCH, DEC_FEATURES = 64, 4, 256, 2048
# JPEG files -> captions: the committed fixtures (500 x 375 and 375 x 500);
# the six baseline ones tiled to four batches, as in earlier runs.
FIXTURES = ROOT / "tests" / "data" / "torch_jpeg"
BASELINE_FIXTURES = ("a_420.jpg", "b_422.jpg", "c_444.jpg", "d_gray.jpg", "e_restart.jpg",
                     "f_optimized.jpg")
PROGRESSIVE_FIXTURE = "g_progressive.jpg"
# Arithmetic-coded: SOF9 4:2:0 with restarts, SOF10.
ARITH_FIXTURES = ("j_arith.jpg", "k_arith_progressive.jpg")
DATASET_IMAGES = 4 * BATCH
# Bundle and evaluation: evaluate's images, references an image and batch;
# fit(val_data)'s training and validation rows and epochs.
EVAL_IMAGES, EVAL_REFS, EVAL_BATCH = 1000, 5, 256
FIT_TRAIN, FIT_VAL, FIT_EPOCHS = 2048, 512, 3
# The CLI workflow: images, captions an image, train / dev / test ids,
# extract's and train's batches, epochs, images captioned.
CLI_MODEL = ("--preset", "config1")
CLI_IMAGES, CLI_REFS, CLI_SPLITS = 512, 5, (384, 64, 64)
CLI_EXTRACT_BATCH, CLI_TRAIN_BATCH, CLI_EPOCHS, CLI_CAPTIONED = 32, 64, 3, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    captured in one CUDA graph and timed with CUDA events around a replay,
    so host-side launch cost (Python, ctypes) does not stand in for the
    device time of a microsecond-scale kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture: allocator, cuBLAS handles
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, rtol, atol):
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol, msg=lambda m: f"{name}: {m}")


def against_bound(r: dict) -> str:
    """A kernel's share of its bound and its time over the library call's."""
    lib = f"{r['ms'] / r['library_ms']:.2f}x library" if r["library_ms"] else "no library call"
    return f"share of bound {r['bound_ms'] / r['ms']:.4f}; {lib}"


# -- phase 2: kernels against their plain versions ---------------------------


def _affine(mode, dev):
    from tpucap_torch.ops.preprocess import _mode_scale_bias

    scale, bias, flip = _mode_scale_bias(mode)
    return torch.from_numpy(scale).to(dev), torch.from_numpy(bias).to(dev), flip


def check_kernels(dev) -> dict[str, dict]:
    """Check every kernel at the main path's shapes in f32 and bf16; time
    it in bf16 (the main path's dtype). -> per-kernel JSON fields."""
    from tpucap_torch.ops import decoder_step, lstm_step, preprocess

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(1)
    M, U, V = BATCH * BEAM, WIDTH, VOCAB
    out = {}

    # K1: uint8 -> normalized; caffe is exact (integer + f32 bias); the
    # scaled modes allow one FMA rounding (2e-6 at |y| <= 2.7), and a bf16
    # output one bf16 ulp (2**-7 relative) where that rounding crosses a
    # bf16 rounding boundary.
    imgs = torch.randint(0, 256, (BATCH, IMAGE, IMAGE, 3), generator=g, device=dev, dtype=torch.uint8)
    odd = torch.randint(0, 256, (8, 300, 250, 3), generator=g, device=dev, dtype=torch.uint8)
    # The same-size kernel's tail (3 x 9 x 7 pixels, no multiple of 8), and
    # a source 189 bytes into its tensor (not 8-byte aligned: the gather
    # kernel takes it).
    small = torch.randint(0, 256, (4, 9, 7, 3), generator=g, device=dev, dtype=torch.uint8)
    cases = ((imgs, IMAGE), (odd, IMAGE), (odd, 299), (small[1:], 9), (small[:3], 9))
    for mode, tol in (("caffe", 0.0), ("tf", 2e-6), ("torch", 2e-6)):
        for src, size in cases:
            scale, bias, flip = _affine(mode, dev)
            rows = preprocess._index_table(size, src.shape[1], src.device)
            cols = preprocess._index_table(size, src.shape[2], src.device)
            for dt in (torch.float32, torch.bfloat16):
                got = preprocess.preprocess_u8(src, (size, size), mode, dt)
                want = preprocess.preprocess_u8_plain(src, rows, cols, scale, bias, flip, dt)
                rt = 0.0 if dt == torch.float32 else 2**-7
                check_close(f"preprocess_u8 {mode} {tuple(src.shape)} -> {size} {dt}", got, want, rt, tol)
    # CONFIG_2's serving batch (phase 9): InceptionV3's 299, same size, tf.
    big = torch.randint(0, 256, (P9_IMAGES, 299, 299, 3), generator=g, device=dev, dtype=torch.uint8)
    scale, bias, flip = _affine("tf", dev)
    rows = preprocess._index_table(299, 299, dev)
    for dt in (torch.float32, torch.bfloat16):
        got = preprocess.preprocess_u8(big, (299, 299), "tf", dt)
        want = preprocess.preprocess_u8_plain(big, rows, rows, scale, bias, flip, dt)
        check_close(f"preprocess_u8 tf {tuple(big.shape)} -> 299 {dt}", got, want,
                    0.0 if dt == torch.float32 else 2**-7, 2e-6)
        log(f"kernel preprocess_u8 tf {tuple(big.shape)} -> 299 {dt}: ok  max_abs_err={max_err(got, want):.3g}")
    del big, got, want
    scale, bias, flip = _affine("caffe", dev)
    rows = preprocess._index_table(IMAGE, IMAGE, dev)
    kern = lambda: preprocess.preprocess_u8(imgs, (IMAGE, IMAGE), "caffe", torch.bfloat16)  # noqa: E731
    plain = lambda: preprocess.preprocess_u8_plain(imgs, rows, rows, scale, bias, flip, torch.bfloat16)  # noqa: E731
    y = kern()
    b_ms, b_by = bound(nbytes(imgs, y, rows, rows), 2 * y.numel(), torch.float32)
    out["preprocess_u8"] = dict(
        max_abs_err=max_err(y, plain()), ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )

    # K2 + K3 inputs at the decode shape: 768 hypotheses, 256 units, vocab 7579.
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    base = dict(
        x=rnd(M, U, scale=0.05), h=rnd(M, U, scale=0.5), c=rnd(M, U),
        wk=rnd(U, 4 * U, scale=U**-0.5), wr=rnd(U, 4 * U, scale=U**-0.5), b=rnd(4 * U, scale=0.1),
        fe=rnd(M, U).relu(), wp=rnd(U, U, scale=U**-0.5), bp=rnd(U, scale=0.1),
        wo=rnd(U, V, scale=U**-0.5), bo=rnd(V, scale=0.1),
    )
    # K2 also at a ragged batch (37 images x beam 3, no multiple of a row
    # tile) with E = 2U, so x and h split the reduction unevenly; K3's
    # projection at that batch and an odd vocabulary of 1001 (a ragged last
    # row tile and column tile).
    Br, Er, Vr = 111, 2 * U, 1001
    ragged = dict(
        x=rnd(Br, Er, scale=0.05), h=rnd(Br, U, scale=0.5), c=rnd(Br, U),
        wk=rnd(Er, 4 * U, scale=Er**-0.5), wr=rnd(U, 4 * U, scale=U**-0.5), b=rnd(4 * U, scale=0.1),
        merged=rnd(Br, U).relu(), wo=rnd(U, Vr, scale=U**-0.5), bo=rnd(Vr, scale=0.1),
        fe=rnd(Br, U).relu(), h32=rnd(Br, U, scale=0.5),
    )
    # K2 + K3 inputs at every row count of the served and dialled decodes
    # (up to phase 16's 3072) and phase 17's first-token draw (4096, f32).
    R = max(*P16_STEP_ROWS, *P18_STEP_ROWS, P17_DRAW_ROWS)
    tall = dict(x=rnd(R, U, scale=0.05), h=rnd(R, U, scale=0.5), c=rnd(R, U), fe=rnd(R, U).relu())

    def check_head(label, fe, h32, wp, bp, dt):
        got = decoder_step.merge_head(fe, h32, wp, bp)
        want = decoder_step.merge_head_plain(fe, h32, wp, bp)
        # f32 both ways: sums of U exact (bf16) or f32 products in another order.
        check_close(f"merge_head {label} {dt}", got, want, 1e-5, 1e-4)
        return got, want

    def check_cell(label, cell, dt):
        got = lstm_step.lstm_cell(*cell)
        want = lstm_step.lstm_cell_plain(*cell)
        # h', c' in the activation dtype (one bf16 ulp); h' f32 to sum order.
        tol = (1e-5, 1e-5) if dt == torch.float32 else (2**-7, 1e-2)
        check_close(f"lstm_cell h {label} {dt}", got[0], want[0], *tol)
        check_close(f"lstm_cell c {label} {dt}", got[1], want[1], *tol)
        check_close(f"lstm_cell h32 {label} {dt}", got[2], want[2], 1e-5, 1e-5)
        return got, want

    for dt in (torch.float32, torch.bfloat16):
        check_cell(f"B={Br} E={Er} U={U}", tuple(ragged[k].to(dt) for k in ("x", "h", "c", "wk", "wr", "b")), dt)
        check_head(f"M={Br}", ragged["fe"].to(dt), ragged["h32"], base["wp"].to(dt), base["bp"].to(dt), dt)
        wo_r, bo_r = ragged["wo"].to(dt), ragged["bo"].to(dt)
        check_close(f"vocab_proj M={Br} V={Vr} {dt}", decoder_step.vocab_proj(ragged["merged"], wo_r, bo_r),
                    decoder_step.vocab_proj_plain(ragged["merged"], wo_r, bo_r), 1e-5, 1e-4)
        p = {k: v.to(dt) for k, v in base.items()}
        cell = (p["x"], p["h"], p["c"], p["wk"], p["wr"], p["b"])
        got, want = check_cell(f"B={M} E={U} U={U}", cell, dt)
        h32 = want[2]
        m_got, m_want = check_head(f"M={M}", p["fe"], h32, p["wp"], p["bp"], dt)
        l_got = decoder_step.vocab_proj(m_want, p["wo"], p["bo"])
        l_want = decoder_step.vocab_proj_plain(m_want, p["wo"], p["bo"])
        check_close(f"vocab_proj {dt}", l_got, l_want, 1e-5, 1e-4)
        # The continuous engine's ticks (phase 15 (f)-(h)): its 64 lanes
        # greedy, 64 groups of BEAM lanes at beam BEAM; the dialled batch of
        # phase 16: P16_ROWS rows while priming (64), B·k while continuing
        # (192), B·2^C·k constrained (384, 768 and 3072 at C = 1, 2, 4); phase
        # 18's beam pool of 5 (320), diverse 3 x 3 (576) and pool 5 x 3
        # (960); in f32, phase 17's one-step draw of P17_DRAW_ROWS rows.
        for r in P16_STEP_ROWS + P18_STEP_ROWS + ((P17_DRAW_ROWS,) if dt == torch.float32 else ()):
            rows_r = tuple(tall[k][:r].to(dt) for k in ("x", "h", "c"))
            _, want_r = check_cell(f"B={r} E={U} U={U}", rows_r + cell[3:], dt)
            _, head_r = check_head(f"M={r}", tall["fe"][:r].to(dt), want_r[2], p["wp"], p["bp"], dt)
            check_close(f"vocab_proj M={r} {dt}", decoder_step.vocab_proj(head_r, p["wo"], p["bo"]),
                        decoder_step.vocab_proj_plain(head_r, p["wo"], p["bo"]), 1e-5, 1e-4)
            log(f"kernel lstm_cell, merge_head, vocab_proj at {r} rows {dt}: ok")
        if dt == torch.float32:
            # The decodes of f32 params ("mixed" keeps them f32) run the f32
            # routes: fit's monitor (greedy, DEC_TRAIN_BATCH rows), and
            # phase 8's caption (CLI_CAPTIONED images x beam BEAM), train
            # monitor and evaluate (greedy batches of CLI_TRAIN_BATCH).
            for r in (DEC_TRAIN_BATCH, CLI_CAPTIONED * BEAM, CLI_TRAIN_BATCH):
                got, want = check_cell(f"B={r} E={U} U={U}", tuple(t[:r] for t in cell[:3]) + cell[3:], dt)
                m_got, m_want = check_head(f"M={r}", p["fe"][:r], want[2], p["wp"], p["bp"], dt)
                check_close(f"vocab_proj M={r} {dt}", decoder_step.vocab_proj(m_want, p["wo"], p["bo"]),
                            decoder_step.vocab_proj_plain(m_want, p["wo"], p["bo"]), 1e-5, 1e-4)
            continue
        # Timing and bounds in bf16, the main path's dtype.
        w_ih, w_hh = p["wk"].T.contiguous(), p["wr"].T.contiguous()
        zero_b = torch.zeros_like(p["b"])
        out["lstm_cell"] = dict(
            max_abs_err=max(max_err(a, b) for a, b in zip(got, want)),
            ms=cuda_ms(lambda: lstm_step.lstm_cell(*cell)),
            plain_ms=cuda_ms(lambda: lstm_step.lstm_cell_plain(*cell)),
            library_ms=cuda_ms(lambda: torch.lstm_cell(p["x"], (p["h"], p["c"]), w_ih, w_hh, p["b"], zero_b)),
        )
        out["lstm_cell"]["bound_ms"], out["lstm_cell"]["bound_by"] = bound(
            nbytes(*cell, *got), 2 * M * 2 * U * 4 * U, dt
        )
        # The decode's step keeps W_p's and W_o's K-major copies for the
        # whole decode. The nearest one-call yardstick of the head,
        # torch.addmm in f32 on fe + h', leaves out the add and the relu.
        wp_t = decoder_step.weight_kmajor(p["wp"])
        a32, wp32, bp32 = p["fe"].float() + h32, p["wp"].float(), p["bp"].float()
        out["merge_head"] = dict(
            max_abs_err=max_err(m_got, m_want),
            ms=cuda_ms(lambda: decoder_step.merge_head(p["fe"], h32, p["wp"], p["bp"], wp_t)),
            plain_ms=cuda_ms(lambda: decoder_step.merge_head_plain(p["fe"], h32, p["wp"], p["bp"])),
            library_ms=cuda_ms(lambda: torch.addmm(bp32, a32, wp32)),
        )
        # K3's products take bf16 weights; an f32 operand split into bf16
        # terms keeps f32 accuracy on bf16 tensor cores, so both stages are
        # priced at the bf16 rate (bytes bound them either way).
        out["merge_head"]["bound_ms"], out["merge_head"]["bound_by"] = bound(
            nbytes(p["fe"], h32, p["wp"], p["bp"], m_got), 2 * M * U * U, dt
        )
        wo32, bo32 = p["wo"].float(), p["bo"].float()
        wo_t = decoder_step.weight_kmajor(p["wo"])
        out["vocab_proj"] = dict(
            max_abs_err=max_err(l_got, l_want),
            ms=cuda_ms(lambda: decoder_step.vocab_proj(m_want, p["wo"], p["bo"], wo_t)),
            plain_ms=cuda_ms(lambda: decoder_step.vocab_proj_plain(m_want, p["wo"], p["bo"])),
            library_ms=cuda_ms(lambda: torch.addmm(bo32, m_want, wo32)),
        )
        out["vocab_proj"]["bound_ms"], out["vocab_proj"]["bound_by"] = bound(
            nbytes(m_want, p["wo"], p["bo"], l_got), 2 * M * U * V, dt
        )
    for name, r in out.items():
        log(
            f"kernel {name}: ok  max_abs_err={r['max_abs_err']:.3g}  ms={r['ms']:.4f}  "
            f"plain_ms={r['plain_ms']:.4f}  library_ms={r['library_ms']}  "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); {against_bound(r)}"
        )
    return out


def _block_params(C, M, g, dev, dt):
    """Folded identity-block params as the bf16 pipeline holds them: OIHW
    kernels in channels_last memory, glorot-scale weights, small biases."""

    def conv(o, i, k):
        w = torch.randn((o, i, k, k), generator=g, device=dev) * (i * k * k) ** -0.5
        return {
            "kernel": w.to(dt).contiguous(memory_format=torch.channels_last),
            "bias": (torch.randn(o, generator=g, device=dev) * 0.1).to(dt),
        }

    return conv(M, C, 1), conv(M, M, 3), conv(C, M, 1)


def check_identity_block(dev) -> dict:
    """K4 at each stage shape: bf16 at batch 256 (checked and timed) and
    f32 at batch K4_F32_BATCH (checked). -> JSON fields per launch, as for
    every other kernel (the mean over one encoder pass's 12 launches, each
    stage weighted by its blocks); the pass totals under ``pass_*`` and the
    stages beside."""
    from tpucap_torch.models.encoders.resnet50 import ResNet50
    from tpucap_torch.ops.bottleneck import fused_identity_block, fused_identity_block_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(4)

    def check(label, p1, p2, p3, x):
        got = fused_identity_block(p1, p2, p3, x)
        want = fused_identity_block_plain(p1, p2, p3, x)
        torch.cuda.synchronize()
        if x.dtype == torch.float32:
            # f32 sums of C, 9M and M products in another order
            # (tpucap's own kernel test: atol 1e-4, rtol 1e-5).
            check_close(f"identity_block {label} f32", got, want, 1e-5, 1e-4)
        else:
            # Each of the three convs rounds an f32 sum to bf16; a sum in
            # another order can land on the neighbouring bf16 value, and
            # that carries into the next conv: two bf16 ulps (2**-6
            # relative, 2**-6 of the output's scale absolute).
            scale = float(want.float().abs().max())
            check_close(f"identity_block {label} bf16", got, want, 2**-6, 2**-6 * scale)
        return got, want

    for label, B, H, W, C, M in K4_RAGGED:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((B, H, W, C), generator=g, device=dev).relu().to(dt)
            got, want = check(f"{label} x{tuple(x.shape)} M={M}", *_block_params(C, M, g, dev, dt), x)
            log(f"kernel identity_block {label} x{tuple(x.shape)} M={M} {dt}: ok  "
                f"max_abs_err={max_err(got, want):.3g}")
    stages, err = {}, 0.0
    for name, S, C, M, blocks in STAGES:
        for dt, batch in ((torch.float32, K4_F32_BATCH), (torch.bfloat16, BATCH)):
            p1, p2, p3 = _block_params(C, M, g, dev, dt)
            x = torch.randn((batch, S, S, C), generator=g, device=dev).relu().to(dt)
            got, want = check(name, p1, p2, p3, x)
            if dt == torch.float32:
                continue
            err = max(err, max_err(got, want))
            blk = {f"b_{i}_conv": q for i, q in zip((1, 2, 3), (p1, p2, p3))}
            w_bytes = nbytes(*(t for q in (p1, p2, p3) for t in q.values()))
            b_ms, b_by = bound(nbytes(x, got) + w_bytes, 2 * batch * S * S * (2 * C * M + 9 * M * M), dt)
            stages[name] = dict(
                blocks=blocks, max_abs_err=max_err(got, want),
                ms=cuda_ms(lambda: fused_identity_block(p1, p2, p3, x), 10),
                plain_ms=cuda_ms(lambda: fused_identity_block_plain(p1, p2, p3, x), 3),
                unfused_ms=cuda_ms(lambda: ResNet50()._block(blk, x, "b", 1, False), 10),
                bound_ms=b_ms, bound_by=b_by,
            )
            r = stages[name]
            log(f"kernel identity_block {name} x{tuple(x.shape)} M={M}: ok  max_abs_err={r['max_abs_err']:.3g}  "
                f"ms={r['ms']:.4f}  plain_ms={r['plain_ms']:.4f}  unfused_ms={r['unfused_ms']:.4f}  "
                f"bound_ms={b_ms:.4f} ({b_by})")
            del got, want, x
    launches = sum(r["blocks"] for r in stages.values())
    keys = ("ms", "plain_ms", "unfused_ms", "bound_ms")
    total = {k: sum(r[k] * r["blocks"] for r in stages.values()) for k in keys}
    by_bytes = sum(r["bound_ms"] * r["blocks"] for r in stages.values() if r["bound_by"] == "bytes")
    out = dict(
        max_abs_err=err, library_ms=None,
        bound_by="bytes" if by_bytes >= total["bound_ms"] / 2 else "operations",
        **{k: total[k] / launches for k in keys},
        **{f"pass_{k}": total[k] for k in keys},
        stages=stages,
    )
    log(f"kernel identity_block: per launch (mean of {launches}) ms={out['ms']:.4f}  "
        f"plain_ms={out['plain_ms']:.4f}  unfused_ms={out['unfused_ms']:.4f}  "
        f"bound_ms={out['bound_ms']:.4f} ({out['bound_by']}); per pass ms={out['pass_ms']:.4f}  "
        f"bound_ms={out['pass_bound_ms']:.4f}; {against_bound(out)}")
    return out


def check_flash_attention(dev) -> dict:
    """K5 at ViT-B/16's shape, q, k, v as views of one (B, L, 3H) qkv;
    also at ragged lengths (one partial query and key tile; a last tile of
    one key) with 4 heads."""
    import torch.nn.functional as F

    from tpucap_torch.ops.attention import flash_attention, flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(5)
    scale = VIT_D**-0.5
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for B, L, heads in ((8, 49, 4), (8, 257, 4), (BATCH, VIT_L, VIT_HEADS)):
            H = heads * VIT_D
            qkv = torch.randn((B, L, 3 * H), generator=g, device=dev).to(dt)
            q, k, v = (qkv[..., i * H : (i + 1) * H].view(B, L, heads, VIT_D) for i in range(3))
            got = flash_attention(q, k, v, scale)
            want = flash_attention_plain(q, k, v, scale)
            torch.cuda.synchronize()
            # f32: sums of 64 and L terms in another order. bf16: the
            # probabilities and the output are rounded to bf16, each
            # rounding may land one ulp away (1e-2 at |ctx| <= 1).
            tol = (1e-5, 2e-5) if dt == torch.float32 else (1e-2, 1e-2)
            check_close(f"flash_attention q{tuple(q.shape)} {dt}", got, want, *tol)
        if dt != torch.bfloat16:
            continue
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        b_ms, b_by = bound(nbytes(q, k, v, got), 4 * BATCH * VIT_HEADS * VIT_L * VIT_L * VIT_D, dt)
        out = dict(
            max_abs_err=max_err(got, want),
            ms=cuda_ms(lambda: flash_attention(q, k, v, scale)),
            plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v, scale), 5),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)),
            bound_ms=b_ms, bound_by=b_by,
        )
    log(f"kernel flash_attention q{tuple(q.shape)}: ok  max_abs_err={out['max_abs_err']:.3g}  "
        f"ms={out['ms']:.4f}  plain_ms={out['plain_ms']:.4f}  library_ms={out['library_ms']:.4f}  "
        f"bound_ms={out['bound_ms']:.4f} ({out['bound_by']}); {against_bound(out)}")
    return out


def check_flash_attention_bwd(dev) -> dict[str, dict]:
    """Phase 2d: K5's row statistics and its two backward kernels against
    their plain versions at ViT-B/16's training shape and the ragged ones;
    q, k, v as views of one qkv projection, the gradients written into
    views of one gradient buffer. Timed in bf16 at the training shape."""
    import torch.nn.functional as F

    from tpucap_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(7)
    scale = VIT_D**-0.5
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for B, L, heads in ((8, 49, 4), (8, 257, 4), (TRAIN_BATCH, VIT_L, VIT_HEADS)):
            H = heads * VIT_D
            qkv = torch.randn((B, L, 3 * H), generator=g, device=dev).to(dt)
            do = torch.randn((B, L, heads, VIT_D), generator=g, device=dev).to(dt)
            q, k, v = A.qkv_views(qkv, heads)
            o, lse = A.flash_attention(q, k, v, scale, with_lse=True)
            o_p, lse_p = A.flash_attention_plain(q, k, v, scale, with_lse=True)
            di = A.attention_di(o_p, do)
            grads = torch.full_like(qkv, float("nan"))  # every element must be written
            dq, dk, dv = A.qkv_views(grads, heads)
            A.flash_attention_bwd_dkv(q, k, v, do, lse_p, di, scale, dk, dv)
            A.flash_attention_bwd_dq(q, k, v, do, lse_p, di, scale, dq)
            want = (
                A.flash_attention_bwd_dq_plain(q, k, v, do, lse_p, di, scale),
                *A.flash_attention_bwd_dkv_plain(q, k, v, do, lse_p, di, scale),
            )
            torch.cuda.synchronize()
            label = f"q{tuple(q.shape)} {dt}"
            # The statistics: f32 either way; the bf16 route sums 2^x from
            # the special-function unit (relative error 2^-22 a term).
            check_close(f"flash_attention lse {label}", lse, lse_p, 0.0, 1e-5)
            # Gradients against each one's scale (max |plain|): f32, sums in
            # another order; bf16, p and ds are rounded to bf16 before their
            # products and the gradients at the end: one bf16 ulp (2**-7).
            share = 1e-5 if dt == torch.float32 else 2.0**-7
            errs = []
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
                scale_ref = float(ref.float().abs().max())
                check_close(f"flash_attention_bwd {name} {label}", got, ref, 0.0, share * scale_ref)
                errs.append(max_err(got, ref))
            log(f"kernel flash_attention_bwd {label}: ok  lse max_abs_err={max_err(lse, lse_p):.3g}  "
                f"dq/dk/dv max_abs_err={', '.join(f'{e:.3g}' for e in errs)} (tol {share:.3g} x scale)")
        if dt != torch.bfloat16:
            continue
        # Determinism at the training shape: each block owns its output rows
        # and no kernel adds with atomics, so a second launch of each writes
        # the same bits.
        again = torch.full_like(qkv, float("nan"))
        dq2, dk2, dv2 = A.qkv_views(again, heads)
        A.flash_attention_bwd_dkv(q, k, v, do, lse_p, di, scale, dk2, dv2)
        A.flash_attention_bwd_dq(q, k, v, do, lse_p, di, scale, dq2)
        torch.cuda.synchronize()
        for name, first, second in (("dkv", (dk, dv), (dk2, dv2)), ("dq", (dq,), (dq2,))):
            if not all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(first, second)):
                raise AssertionError(f"flash_attention_bwd_{name} q{tuple(q.shape)} bf16: two launches differ")
        log(f"kernel flash_attention_bwd q{tuple(q.shape)} bf16: two launches of each kernel give identical bits")
        del again, dq2, dk2, dv2
        # Timing and bounds at the training shape, bf16.
        n = TRAIN_BATCH * VIT_HEADS * VIT_L * VIT_L * VIT_D
        stats = nbytes(lse_p, di)
        qt, kt, vt = (a.detach().transpose(1, 2).requires_grad_() for a in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

        sdpa_bwd_ms = cuda_ms(sdpa_fwd_bwd) - cuda_ms(sdpa_fwd)
        attrs = A.flash_attention_bwd_attributes(dt)  # registers, shared memory, blocks an SM
        # Bytes: q, k, v and dO read, the gradients written, the f32
        # statistics read; operations: four products of 2 B h L^2 d for
        # dK/dV (S, dP, dV, dK), three for dQ (S, dP, dQ).
        for name, err, kern, plain, moved, products in (
            (
                "flash_attention_bwd_dkv",
                max(errs[1:]),
                lambda: A.flash_attention_bwd_dkv(q, k, v, do, lse_p, di, scale, dk, dv),
                lambda: A.flash_attention_bwd_dkv_plain(q, k, v, do, lse_p, di, scale),
                nbytes(q, k, v, do, dk, dv) + stats,
                4,
            ),
            (
                "flash_attention_bwd_dq",
                errs[0],
                lambda: A.flash_attention_bwd_dq(q, k, v, do, lse_p, di, scale, dq),
                lambda: A.flash_attention_bwd_dq_plain(q, k, v, do, lse_p, di, scale),
                nbytes(q, k, v, do, dq) + stats,
                3,
            ),
        ):
            b_ms, b_by = bound(moved, products * 2 * n, dt)
            out[name] = dict(
                max_abs_err=err, ms=cuda_ms(kern), plain_ms=cuda_ms(plain, 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=sdpa_bwd_ms, **attrs[name],
            )
        fwd_ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale))
        fwd_lse_ms = cuda_ms(lambda: A.flash_attention(q, k, v, scale, with_lse=True))
        log(f"kernel flash_attention q{tuple(q.shape)} bf16: ms={fwd_ms:.4f} without statistics, "
            f"{fwd_lse_ms:.4f} with")
    for name, r in out.items():
        log(
            f"kernel {name} q{tuple(q.shape)}: ok  max_abs_err={r['max_abs_err']:.3g}  ms={r['ms']:.4f}  "
            f"plain_ms={r['plain_ms']:.4f}  library_ms={r['library_ms']:.4f} (SDPA backward, both "
            f"kernels' work)  bound_ms={r['bound_ms']:.4f} ({r['bound_by']}); {against_bound(r)}; "
            f"{r['registers']} registers a thread, {r['smem_bytes']} bytes of shared memory a block, "
            f"{r['blocks_per_sm']} blocks an SM"
        )
    return out


# -- phase 3: the slice at full width ----------------------------------------


def corpus(n_words: int) -> dict[str, list[str]]:
    """n_words distinct letter-only words in sentences wrapped with the
    sentinels: a vocabulary of n_words + 2 words, vocab n_words + 3."""
    words = []
    for i in range(n_words):
        w = ""
        for _ in range(3):
            w += chr(97 + i % 26)
            i //= 26
        words.append("w" + w)
    caps = [
        "startseq " + " ".join(words[s : s + 12]) + " endseq"
        for s in range(0, n_words, 12)
    ]
    return {"corpus": caps}


def make_pipeline(precision: str, tokenizer=None, encoder: str = "resnet50", seed: int = 0,
                  decoder: str = "lstm1"):
    from tpucap_torch.config import Config, DecodeConfig, DecoderConfig, encoder_config
    from tpucap_torch.pipeline import CaptioningPipeline

    cfg = Config(
        encoder=encoder_config(encoder),
        decoder=DecoderConfig(name=decoder, embed_dim=WIDTH, hidden_dim=WIDTH),
        decode=DecodeConfig(method="beam", beam_width=BEAM, max_len=MAX_LEN),
        precision=precision,
    )
    pipe = CaptioningPipeline(cfg, tokenizer=tokenizer)
    if tokenizer is None:
        pipe.fit_tokenizer(corpus(VOCAB - 3))
    if pipe.vocab_size != VOCAB:
        raise AssertionError(f"vocab {pipe.vocab_size} != {VOCAB}")
    pipe.build(seed=seed)
    # Random ResNet-50 features of noise images are large and nearly alike
    # (mean |f| about 5.6, spread across images about 0.16 on the CPU at
    # this width), so the image branch would pick the same word at every
    # step for every image. Shrunk, it leaves the word path to choose, the
    # captions differ, and the agreement phase compares varied sequences.
    # The ViT path takes the same scaling.
    pipe.params["decoder"]["feat_proj"]["kernel"].mul_(1e-3)
    pipe.fold_bn()
    return pipe


def timed(fn) -> tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def run_path(dev, label: str, pipe, encoder_launches: dict[str, int], work=None) -> dict[str, int]:
    """One full-width batch of ``pipe.caption_batch`` with the counters
    reset just before and read just after; then two more for the median.
    ``encoder_launches``: the encoder kernels' launches per batch. With
    ``work`` (a ``DialWork`` on ``pipe``: a decoder whose step is plain)
    the decode steps are its counted steps and K2 and K3 launch nothing."""
    from tpucap_torch import ops
    from tpucap_torch.ops.preprocess import fused_preprocess

    enc = pipe.encoder
    g = torch.Generator(device=dev).manual_seed(2)
    images = torch.randint(0, 256, (BATCH, IMAGE, IMAGE, 3), generator=g, device=dev, dtype=torch.uint8)

    def encode():
        with torch.inference_mode():
            x = fused_preprocess(images, enc.input_size, enc.preprocess_mode, out_dtype=torch.bfloat16)
            return pipe._apply_encoder(pipe._inference_params()["encoder"], x)

    feats, _ = timed(encode)
    if feats.shape != (BATCH, enc.feature_dim) or not torch.isfinite(feats).all():
        raise AssertionError(f"{label}: features {tuple(feats.shape)} not finite/expected")
    pipe.caption_batch(images)  # warm-up: cuDNN plans, allocator
    enc_s = min(timed(encode)[1] for _ in range(3))

    ops.reset_launch_counts()
    before = work.steps if work is not None else 0
    caps, batch_s = timed(lambda: pipe.caption_batch(images))
    counts = ops.launch_counts()
    steps = counts["lstm_cell"] if work is None else work.steps - before
    more = [timed(lambda: pipe.caption_batch(images))[1] for _ in range(2)]

    if len(caps) != BATCH or not all(isinstance(c, str) for c in caps):
        raise AssertionError(f"{label}: caption_batch returned a malformed batch")
    expect = {name: 0 for name in counts}
    expect.update(preprocess_u8=1, **encoder_launches)
    if work is None:
        expect.update(lstm_cell=steps, merge_head=steps, vocab_proj=steps)
    if not 1 <= steps <= MAX_LEN or counts != expect:
        raise AssertionError(f"{label}: launch counts {counts} != {expect}")
    med = float(np.median([batch_s, *more]))
    log(f"{label}: batch seconds {[round(s, 5) for s in (batch_s, *more)]} median {med:.5f}")
    log(f"{label}: captions/s {BATCH / med:.2f}")
    log(f"{label}: preprocess+encoder ms {enc_s * 1e3:.3f}; decode steps {steps}; "
        f"ms per decode step {(med - enc_s) * 1e3 / steps:.3f}")
    log(f"{label}: launches in one batch {counts}")
    for c in caps[:3]:
        log(f"{label}: caption: {c!r}")
    return counts


def run_slice(dev) -> tuple[dict[str, int], object]:
    pipe = make_pipeline("bf16")
    log(f"slice: batch {BATCH} resnet50+lstm1 beam {BEAM} vocab {VOCAB} bf16")
    return run_path(dev, "slice", pipe, {}), pipe.tokenizer


def run_fused(dev, tokenizer) -> dict[str, int]:
    """Path A: ResNet-50 with its 12 identity blocks as K4."""
    pipe = make_pipeline("bf16", tokenizer)
    pipe.encoder = dataclasses.replace(pipe.encoder, fused_blocks=True)
    log(f"fused: batch {BATCH} resnet50(fused_blocks=True)+lstm1 beam {BEAM} vocab {VOCAB} bf16")
    return run_path(dev, "fused", pipe, {"identity_block": 12})


def run_vit(dev, tokenizer) -> dict[str, int]:
    """Path B: ViT-B/16 with its 12 attention layers as K5."""
    pipe = make_pipeline("bf16", tokenizer, encoder="vit_b16")
    pipe.encoder = dataclasses.replace(pipe.encoder, attention_impl="flash")
    e = pipe.encoder
    log(f"vit: batch {BATCH} vit_b16 ({e.input_size}px/{e.patch_size}, {e.num_layers}x{e.hidden_dim}, "
        f"{e.num_heads} heads, mlp {e.mlp_dim}, flash)+lstm1 beam {BEAM} vocab {VOCAB} bf16")
    return run_path(dev, "vit", pipe, {"flash_attention": e.num_layers})


# -- phase 4: kernel path against plain path ---------------------------------


def agreement(dev, tokenizer) -> None:
    from tpucap_torch.ops.decoder_step import make_fused_merge_step
    from tpucap_torch.ops.preprocess import _index_table, preprocess_u8_plain

    pipe = make_pipeline("f32", tokenizer)
    g = torch.Generator(device=dev).manual_seed(3)
    images = torch.randint(0, 256, (AGREE_BATCH, IMAGE, IMAGE, 3), generator=g, device=dev, dtype=torch.uint8)
    kernel_caps = pipe.caption_batch(images)

    scale, bias, flip = _affine("caffe", dev)
    idx = _index_table(IMAGE, IMAGE, dev)
    params = pipe._inference_params()
    with torch.inference_mode():
        x = preprocess_u8_plain(images, idx, idx, scale, bias, flip, torch.float32)
        feats = pipe._apply_encoder(params["encoder"], x)
        state = pipe.decoder.init_state(params["decoder"], feats)
        start = torch.full((AGREE_BATCH,), pipe._token_ids()[0], device=dev)
        lk, _ = make_fused_merge_step(pipe.decoder)(params["decoder"], state, start)
        lp, _ = pipe.decoder.step(params["decoder"], state, start)
        # f32 both ways; sums of 256 products in another order.
        check_close("first-step logits", lk, lp, 1e-5, 1e-4)
        pipe.step_fn = lambda: pipe.decoder.step  # the plain step on the card
        plain_caps = pipe._captions(pipe._decode(params["decoder"], feats, "beam", BEAM))
    same = sum(a == b for a, b in zip(kernel_caps, plain_caps))
    log(f"agreement: first-step logits max_abs_err {max_err(lk, lp):.3g} (tol 1e-4 + 1e-5 rel)")
    log(f"agreement: f32 batch {AGREE_BATCH}: {same}/{AGREE_BATCH} captions identical "
        f"({same / AGREE_BATCH:.3f})")


def agreement_encoders(dev, tokenizer) -> None:
    """f32 at batch 32: K4 against the unfused ResNet-50 and K5 against
    the ViT's xla attention, on features and on captions."""
    from tpucap_torch.ops.preprocess import fused_preprocess

    g = torch.Generator(device=dev).manual_seed(6)
    images = torch.randint(0, 256, (AGREE_BATCH, IMAGE, IMAGE, 3), generator=g, device=dev, dtype=torch.uint8)
    for label, encoder, field, kernel_value in (
        ("fused blocks", "resnet50", "fused_blocks", True),
        ("vit flash", "vit_b16", "attention_impl", "flash"),
    ):
        pipe = make_pipeline("f32", tokenizer, encoder=encoder)
        plain_enc = pipe.encoder
        kernel_enc = dataclasses.replace(plain_enc, **{field: kernel_value})
        with torch.inference_mode():
            x = fused_preprocess(images, plain_enc.input_size, plain_enc.preprocess_mode)
            params = pipe._inference_params()["encoder"]
            want = plain_enc.apply(params, x)
            got = kernel_enc.apply(params, x)
        # f32 both ways (TF32 off): sums in another order through every
        # layer; tpucap's own tolerance for the fused blocks (atol 5e-4,
        # rtol 1e-4, tests/test_ops.py), for both encoders.
        check_close(f"{label} features", got, want, 1e-4, 5e-4)
        plain_caps = pipe.caption_batch(images)
        pipe.encoder = kernel_enc
        kernel_caps = pipe.caption_batch(images)
        same = sum(a == b for a, b in zip(kernel_caps, plain_caps))
        log(f"agreement: {label} f32 batch {AGREE_BATCH}: features max_abs_err {max_err(got, want):.3g} "
            f"(tol 5e-4 + 1e-4 rel); {same}/{AGREE_BATCH} captions identical "
            f"({same / AGREE_BATCH:.3f})")

    # bf16: K4 against the unfused bf16 block (cuDNN convs, each rounded to
    # bf16 before its bias is added in bf16, as K4 rounds), one block, then
    # the whole encoder.
    pipe = make_pipeline("bf16", tokenizer)
    plain_enc = pipe.encoder
    kernel_enc = dataclasses.replace(plain_enc, fused_blocks=True)
    params = pipe._inference_params()["encoder"]
    with torch.inference_mode():
        x = fused_preprocess(images, plain_enc.input_size, plain_enc.preprocess_mode, out_dtype=torch.bfloat16)
        y = torch.randn((AGREE_BATCH, 28, 28, 512), generator=g, device=x.device).relu().to(torch.bfloat16)
        b_got = kernel_enc._block(params, y, "conv3_block2", 1, False)
        b_want = plain_enc._block(params, y, "conv3_block2", 1, False)
        got, want = kernel_enc.apply(params, x), plain_enc.apply(params, x)
    # One block: three convs, each sum rounded to bf16 in another order,
    # the difference carried into the next conv: two bf16 ulps (K4's own
    # tolerance against its plain version). The encoder: those last bits
    # compound through 12 fused blocks: 2 % of the features' scale (about
    # two and a half bf16 ulps; the port against tpucap in bf16 on the CPU
    # measured 0.6 %, tests/test_torch_bf16.py).
    b_scale = float(b_want.float().abs().max())
    check_close("fused blocks bf16 block conv3_block2", b_got, b_want, 2**-6, 2**-6 * b_scale)
    f_scale = float(want.float().abs().max())
    check_close("fused blocks bf16 features", got, want, 0.0, 0.02 * f_scale)
    log(f"agreement: fused blocks bf16 batch {AGREE_BATCH}: block max_abs_err {max_err(b_got, b_want):.3g} "
        f"(tol 2**-6 rel + 2**-6 x {b_scale:.3g}); features max_abs_err {max_err(got, want):.3g} "
        f"(tol 0.02 x {f_scale:.3g})")


# -- phase 5: training at full width -----------------------------------------


def training_corpus(tokenizer, n: int, seed: int, refs: int = 1,
                    prefix: str = "img") -> dict[str, list[str]]:
    """n images with ``refs`` captions each of 8 to 30 of the vocabulary's
    words."""
    rng = np.random.default_rng(seed)
    words = [w for w in tokenizer.word_index if w not in ("startseq", "endseq")]
    return {
        f"{prefix}{i}": [
            "startseq " + " ".join(rng.choice(words, rng.integers(8, 31))) + " endseq"
            for _ in range(refs)
        ]
        for i in range(n)
    }


def train_decoder(dev) -> None:
    """5(a): ``make_train_step`` at bench.py --mode train's shapes, bf16
    compute with f32 master params. The teacher-forced loop runs the plain
    cell under autograd (tpucap trains with its plain scan; K2 is
    forward-only), so no kernel of the port launches."""
    decoder_train_steps(dev, "train decoder", "lstm1", (DEC_TRAIN_BATCH, DEC_FEATURES))


def decoder_train_steps(dev, label: str, name: str, feat_shape: tuple, decoder: dict | None = None,
                        **step_kw) -> list[float]:
    """``make_train_step`` of decoder ``name`` (embed and hidden WIDTH,
    vocab VOCAB, the feature width feat_shape[-1], ``decoder``'s other
    ``build_decoder`` fields) on one batch of seeded features and (batch,
    MAX_LEN + 1) tokens, bf16 compute with f32 master params: a warm-up
    step, then 5 timed, no kernel launched (the training loop is plain).
    -> the 5 losses."""
    from tpucap_torch import ops
    from tpucap_torch.config import TrainConfig
    from tpucap_torch.models.decoders import build_decoder
    from tpucap_torch.train import TrainState, build_optimizer, make_train_step

    batch = feat_shape[0]
    dec = build_decoder(name, VOCAB, feat_shape[-1], embed_dim=WIDTH, hidden_dim=WIDTH, **(decoder or {}))
    params = tree_to(dec.init(torch.Generator().manual_seed(0)), dev)
    opt = build_optimizer(TrainConfig())
    state = TrainState.create(params, opt, torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(dec, opt, compute_dtype=torch.bfloat16, donate=True, **step_kw)
    g = torch.Generator(device=dev).manual_seed(8)
    feats = torch.randn(feat_shape, generator=g, device=dev)
    tokens = torch.randint(1, VOCAB, (batch, MAX_LEN + 1), generator=g, device=dev)
    state, m = step(state, feats, tokens)  # warm-up: allocator, cuBLAS
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(5):
        (state, m), s = timed(lambda: step(state, feats, tokens))
        times.append(s)
        losses.append(float(m["loss"]))
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"{label}: kernels launched {counts}; the training loop is plain")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses} not finite")
    med = float(np.median(times))
    extra = "".join(f", {k} {v}" for k, v in {**(decoder or {}), **step_kw}.items())
    log(f"{label}: {name} batch {batch} features {tuple(feat_shape[1:])} T {MAX_LEN + 1} vocab {VOCAB} bf16 "
        f"compute, f32 masters{extra}: step ms {[round(t * 1e3, 3) for t in times]} median {med * 1e3:.3f}; "
        f"samples/s {batch / med:.2f}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"losses {[round(x, 4) for x in losses]}")
    return losses


def tree_to(tree, dev):
    from tpucap_torch.core import tree_map

    return tree_map(lambda t: t.to(dev), tree)


def finetune_pipeline(tokenizer, precision: str):
    from tpucap_torch.config import Config, DecodeConfig, DecoderConfig, TrainConfig, encoder_config
    from tpucap_torch.pipeline import CaptioningPipeline

    cfg = Config(
        encoder=encoder_config("vit_b16"),
        decoder=DecoderConfig(name="lstm1", embed_dim=WIDTH, hidden_dim=WIDTH),
        decode=DecodeConfig(max_len=MAX_LEN),
        train=TrainConfig(batch_size=TRAIN_BATCH, precision=precision),
        precision="bf16" if precision == "bf16" else "f32",
    )
    pipe = CaptioningPipeline(cfg, tokenizer=tokenizer)
    pipe.encoder = dataclasses.replace(pipe.encoder, attention_impl="flash")
    pipe.build(seed=0)
    return pipe


def train_finetune(dev, tokenizer) -> dict[str, int]:
    """5(b): ``fit_finetune`` with ViT-B/16 (flash) and lstm1 on one batch
    of TRAIN_BATCH images for TRAIN_STEPS steps, in f32 and in bf16, the
    counters reset just before and read just after each run. -> the bf16
    run's counts."""
    from tpucap_torch import ops

    desc = training_corpus(tokenizer, TRAIN_BATCH, 9)
    rng = np.random.default_rng(10)
    images = {k: rng.uniform(-1, 1, size=(IMAGE, IMAGE, 3)).astype(np.float32) for k in desc}
    counts = {}
    for precision in ("f32", "bf16"):
        pipe = finetune_pipeline(tokenizer, precision)
        pipe.fit_finetune(desc, images, epochs=1, log=None)  # warm-up: allocator, cuBLAS, cuDNN
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        hist, s = timed(lambda: pipe.fit_finetune(desc, images, epochs=TRAIN_STEPS, log=None))
        counts = ops.launch_counts()
        layers = pipe.encoder.num_layers
        expect = {name: 0 for name in counts}
        expect.update(
            flash_attention=layers * TRAIN_STEPS,
            flash_attention_bwd_dkv=layers * TRAIN_STEPS,
            flash_attention_bwd_dq=layers * TRAIN_STEPS,
        )
        if counts != expect:
            raise AssertionError(f"fit_finetune {precision}: launch counts {counts} != {expect}")
        losses = [h["loss"] for h in hist]
        if len(hist) != TRAIN_STEPS or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"fit_finetune {precision}: losses {losses} not finite and descending")
        step_s = s / TRAIN_STEPS
        log(f"train finetune {precision}: vit_b16 flash + lstm1, batch {TRAIN_BATCH}, vocab {VOCAB}, "
            f"{TRAIN_STEPS} steps: step ms {step_s * 1e3:.3f} (wall of fit_finetune over its steps, host batch "
            f"assembly included); images/s {TRAIN_BATCH / step_s:.2f}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches per step "
            f"{ {k: v // TRAIN_STEPS for k, v in counts.items() if v} }; losses {[round(x, 4) for x in losses]}")
        del pipe
    return counts


def train_agreement(dev, tokenizer) -> None:
    """5(c): f32, one joint step's loss and gradients with the kernels
    (flash: K5 forward with statistics, dK/dV, dQ) against the same with
    the plain attention (xla), same params and batch, TF32 off."""
    from tpucap_torch.core import apply_precision, tree_leaves
    from tpucap_torch.train import (
        build_training_tokens,
        caption_loss_sums,
        encode_for_decoder,
        loss_from_sums,
    )
    from tpucap_torch.train.loop import grads_of, trainable

    pipe = finetune_pipeline(tokenizer, "f32")
    apply_precision("f32")
    desc = training_corpus(tokenizer, TRAIN_BATCH, 11)
    _, tokens = build_training_tokens(tokenizer, desc, MAX_LEN)
    tokens = torch.from_numpy(tokens).to(dev).long()
    g = torch.Generator(device=dev).manual_seed(12)
    images = torch.rand((TRAIN_BATCH, IMAGE, IMAGE, 3), generator=g, device=dev) * 2 - 1
    results = {}
    for impl in ("flash", "xla"):
        enc = dataclasses.replace(pipe.encoder, attention_impl=impl)
        params = trainable(pipe.params)
        feats = encode_for_decoder(enc, params["encoder"], images)
        loss, _ = loss_from_sums(caption_loss_sums(pipe.decoder, params["decoder"], feats, tokens))
        results[impl] = (loss.item(), tree_leaves(grads_of(loss, params)))
    (lk, gk), (lp, gp) = results["flash"], results["xla"]
    # f32 both ways, TF32 off: the attention's sums in another order (online
    # softmax against one pass), carried through twelve layers' backward,
    # where sums over all tokens cancel (a layer norm's bias gradient): the
    # loss within 1e-5 relative, each gradient within 1e-4 of its tensor's
    # scale (the CPU tests saw up to 2e-5 from summation order alone).
    if abs(lk - lp) > 1e-5 * abs(lp):
        raise AssertionError(f"train agreement: loss {lk} (kernels) against {lp} (plain)")
    worst = 0.0
    for a, b in zip(gk, gp):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if err > 1e-4 * scale:
            raise AssertionError(f"train agreement: a gradient differs by {err} at scale {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    log(f"train agreement: f32 joint step, batch {TRAIN_BATCH}: loss {lk:.7f} (kernels) against {lp:.7f} "
        f"(plain), relative {abs(lk - lp) / abs(lp):.3g} (tol 1e-5); gradients' worst share of scale "
        f"{worst:.3g} over {len(gk)} tensors (tol 1e-4)")
    apply_precision(pipe.config.precision)


# -- phase 6: JPEG files -> captions -----------------------------------------


def host_info() -> None:
    """What the host offers the decoder; the log only reads it."""
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
    try:
        ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
        libjpeg = "libjpeg" in ldconfig
    except FileNotFoundError:
        libjpeg = "no ldconfig"
    pil = importlib.util.find_spec("PIL") is not None
    log(f"jpeg: host {gxx.splitlines()[0] if gxx else 'no g++'}; os.cpu_count() {os.cpu_count()}; "
        f"libjpeg in ldconfig: {libjpeg}; PIL importable: {pil} (the port uses neither)")


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def check_jpeg_fixtures() -> dict[str, Path]:
    """6b: this machine's build of the decoder against the digests tpucap's
    libjpeg decode recorded (scripts/make_torch_jpeg_fixtures.py), at each
    fixture's own size and at 224, at 8/8 (fast_scale=False) and at
    tpucap's default fast_scale=True (5/8 for these sizes); the CMYK and
    YCCK fixtures against tpucap's load_image digests, through the port's
    load_image route (its own decoder: no JPEG reaches PIL), and refused on
    the RGB route as libjpeg-turbo refuses them."""
    from tpucap_torch.data.preprocess import load_images
    from tpucap_torch.ops import jpeg

    digests = json.loads((FIXTURES / "digests.json").read_text())
    size = digests["size"]
    paths = {}
    for name, want in sorted(digests["files"].items()):
        path = FIXTURES / name
        blob = path.read_bytes()
        if list(jpeg.jpeg_dims(blob)) != want["shape"]:
            raise AssertionError(f"jpeg: {name}: dims {jpeg.jpeg_dims(blob)} != {want['shape']}")
        if want.get("reference") == "load_image":
            got = {"native": sha256(jpeg.decode_jpeg(blob, load_image=True)),
                   str(size): sha256(load_images([path], size=size)[0])}
            if jpeg.decode_files([path], size)[1][0] != 5:
                raise AssertionError(f"jpeg: {name}: the RGB route does not refuse it (status 5)")
            wrong = [k for k, v in got.items() if v != want[k]]
            if wrong:
                raise AssertionError(f"jpeg: {name}: load_image route differs from tpucap's "
                                     f"load_image digests at {wrong}")
            paths[name] = path
            continue
        got = {
            "native": sha256(jpeg.decode_jpeg(blob)),
            str(size): sha256(jpeg.decode_jpeg_files([path], size, fast_scale=False)[0]),
            f"{size}_fast": sha256(jpeg.decode_jpeg_files([path], size)[0]),
        }
        if sha256(jpeg.decode_jpeg_batch([blob], size)[0]) != got[f"{size}_fast"]:
            raise AssertionError(f"jpeg: {name}: decode_jpeg_batch and decode_jpeg_files differ")
        wrong = [k for k, v in got.items() if v != want[k]]
        if wrong:
            raise AssertionError(f"jpeg: {name}: decode differs from libjpeg's digests at {wrong}")
        paths[name] = path
    log(f"jpeg: {len(paths)} fixtures ({', '.join(paths)}) decode to their SHA-256 at their "
        f"own size and at {size}: libjpeg's with fast_scale False (8/8) and True (5/8), "
        f"load_image's for the CMYK and YCCK ones")
    return paths


def decode_rate(blobs, size: int, n_threads: int, fast_scale: bool) -> float:
    """Images/s of the host decoder on one batch, best of three."""
    from tpucap_torch.ops import jpeg

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jpeg.decode_jpeg_batch(blobs, size, n_threads=n_threads, fast_scale=fast_scale)
        best = min(best, time.perf_counter() - t0)
    return len(blobs) / best


def log_decode_rates(label: str, blobs, size: int) -> None:
    """6d: the host decoder's images/s at one thread and at the default,
    with fast_scale True (tpucap's default) and False."""
    rates = {fast: (decode_rate(blobs, size, 1, fast), decode_rate(blobs, size, 0, fast))
             for fast in (True, False)}
    log(f"dataset: host decode of {label} -> {size}, images/s at n_threads=1 / the default "
        f"({os.cpu_count()} cpus): fast_scale=True (5/8 + nearest resize) "
        f"{rates[True][0]:.2f} / {rates[True][1]:.2f}; fast_scale=False (8/8 + nearest resize) "
        f"{rates[False][0]:.2f} / {rates[False][1]:.2f}")


def run_dataset(dev, tokenizer, fixtures: dict[str, Path]) -> None:
    """6c/6d: path A (ResNet-50 with fused blocks, lstm1, beam 3, bf16) from
    DATASET_IMAGES JPEG paths through caption_dataset, at tpucap's default
    fast_scale=True and at fast_scale=False, then from as many
    arithmetic-coded paths, each against caption_batch on the same decoded
    batches."""
    pipe = make_pipeline("bf16", tokenizer)
    pipe.encoder = dataclasses.replace(pipe.encoder, fused_blocks=True)
    size = pipe.encoder.input_size
    baseline = [fixtures[name] for name in BASELINE_FIXTURES]
    paths = [str(baseline[i % len(baseline)]) for i in range(DATASET_IMAGES)]
    n_batches = DATASET_IMAGES // BATCH
    log(f"dataset: {DATASET_IMAGES} JPEG paths (the six baseline fixtures tiled, 500x375 and "
        f"375x500) -> {size}, {n_batches} batches of {BATCH}, resnet50(fused_blocks=True)+lstm1 "
        f"beam {BEAM} bf16")
    log_decode_rates("the baseline batch", [Path(p).read_bytes() for p in paths[:BATCH]], size)
    log_decode_rates("a progressive batch (g_progressive.jpg)",
                     [fixtures[PROGRESSIVE_FIXTURE].read_bytes()] * BATCH, size)
    for name in ARITH_FIXTURES:
        log_decode_rates(f"an arithmetic batch ({name})", [fixtures[name].read_bytes()] * BATCH,
                         size)

    for fast_scale in (True, False):
        dataset_against_batches(pipe, paths, f"fast_scale={fast_scale}", fast_scale)
    arith = [str(fixtures[ARITH_FIXTURES[i % 2]]) for i in range(DATASET_IMAGES)]
    log(f"dataset: {DATASET_IMAGES} arithmetic-coded paths ({' and '.join(ARITH_FIXTURES)} "
        f"alternately) -> {size}")
    dataset_against_batches(pipe, arith, "arithmetic, fast_scale=True", True)


def dataset_against_batches(pipe, paths, label: str, fast_scale: bool) -> None:
    """caption_dataset(paths) against caption_batch on the same decoded
    batches: captions equal, K1 1, K2 and K3 a step each, K4 12 a batch."""
    from tpucap_torch import ops
    from tpucap_torch.ops import jpeg

    size = pipe.encoder.input_size
    n_batches = len(paths) // BATCH
    t0 = time.perf_counter()
    batches = [jpeg.decode_jpeg_files(paths[s : s + BATCH], size, fast_scale=fast_scale)
               for s in range(0, len(paths), BATCH)]
    decode_s = time.perf_counter() - t0
    pipe.caption_batch(batches[0])  # warm-up: cuDNN plans, allocator

    kwargs = {} if fast_scale else {"fast_scale": False}  # True is the default
    ops.reset_launch_counts()
    caps, dataset_s = timed(lambda: pipe.caption_dataset(paths, batch_size=BATCH, **kwargs))
    counts = ops.launch_counts()

    ops.reset_launch_counts()
    want, batch_s = timed(lambda: [c for b in batches for c in pipe.caption_batch(b)])
    want_counts = ops.launch_counts()

    if caps != want:
        same = sum(a == b for a, b in zip(caps, want))
        raise AssertionError(f"dataset {label}: caption_dataset agrees with caption_batch on "
                             f"{same} of {len(want)} captions")
    steps = counts["lstm_cell"]
    expect = {name: 0 for name in counts}
    expect.update(preprocess_u8=n_batches, identity_block=12 * n_batches,
                  lstm_cell=steps, merge_head=steps, vocab_proj=steps)
    if (counts != expect or counts != want_counts
            or not n_batches <= steps <= MAX_LEN * n_batches):
        raise AssertionError(f"dataset {label}: launch counts {counts} (caption_batch's "
                             f"{want_counts}), expected {expect}")
    hidden = (decode_s + batch_s - dataset_s) / decode_s
    log(f"dataset {label}: launches over {n_batches} batches {counts}: K1 "
        f"{counts['preprocess_u8'] / n_batches:g}, K2 {steps / n_batches:g}, K3 "
        f"{counts['merge_head'] / n_batches:g} + {counts['vocab_proj'] / n_batches:g}, K4 "
        f"{counts['identity_block'] / n_batches:g} a batch")
    log(f"dataset {label}: caption_dataset {dataset_s:.5f} s, {len(paths) / dataset_s:.2f} "
        f"captions/s; caption_batch on decoded batches {batch_s:.5f} s, "
        f"{len(paths) / batch_s:.2f} captions/s; host decode alone {decode_s:.5f} s")
    log(f"dataset {label}: the overlap hides {100 * hidden:.1f} % of the decode time "
        f"((decode + caption_batch - caption_dataset) / decode); captions identical to "
        f"caption_batch")
    for c in caps[:2]:
        log(f"dataset {label}: caption: {c!r}")


# -- phase 7: bundle and evaluation -----------------------------------------


def random_features(ids, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=DEC_FEATURES).astype(np.float32) for k in ids}


def run_evaluate(pipe) -> list[np.ndarray]:
    """7(a): ``evaluate`` on EVAL_IMAGES feature rows with EVAL_REFS
    references each, batch EVAL_BATCH (the last batch padded), every metric
    family, against ``generate`` on the same padded batches: the same
    captions and launches, K2 and K3 once a decode step. The metrics' host
    time is ``evaluate_captions`` timed on the captions evaluate returned
    (the same scores); evaluate's wall less that holds the decode and the
    host's spread between the two scorings, so ``generate`` on the same
    batches times the decode. -> the padded feature batches."""
    from tpucap_torch import ops
    from tpucap_torch.pipeline import pad_rows
    from tpucap_torch.train.evaluate import METRICS, evaluate_captions

    desc = training_corpus(pipe.tokenizer, EVAL_IMAGES, 13, refs=EVAL_REFS)
    feats = random_features(desc, 14)
    ids = list(desc)
    chunks = [ids[s : s + EVAL_BATCH] for s in range(0, len(ids), EVAL_BATCH)]
    batches = [pad_rows(np.stack([feats[k] for k in c]), EVAL_BATCH) for c in chunks]
    pipe.generate(batches[0])  # warm-up: allocator, cuBLAS
    ops.reset_launch_counts()
    want, generate_s = timed(
        lambda: [cap for c, b in zip(chunks, batches) for cap in pipe.generate(b)[: len(c)]]
    )
    want_counts = ops.launch_counts()
    ops.reset_launch_counts()
    (scores, caps), eval_s = timed(lambda: pipe.evaluate(
        desc, feats, batch_size=EVAL_BATCH, metrics=METRICS, return_captions=True))
    counts = ops.launch_counts()
    rescored, metric_s = timed(lambda: evaluate_captions(desc, caps, metrics=METRICS))

    if list(caps) != ids or list(caps.values()) != want:
        same = sum(a == b for a, b in zip(caps.values(), want))
        raise AssertionError(f"evaluate: {same} of {len(want)} captions equal generate's")
    steps = MAX_LEN * len(batches)
    expect = {name: 0 for name in counts}
    expect.update(lstm_cell=steps, merge_head=steps, vocab_proj=steps)
    if counts != expect or want_counts != expect:
        raise AssertionError(f"evaluate: launch counts {counts} (generate's {want_counts}), "
                             f"expected {expect}")
    bad = {k: v for k, v in scores.items() if v is None or not np.isfinite(v)}
    bad.update({k: scores[k] for k in ("bleu1", "bleu2", "bleu3", "bleu4", "rouge_l", "meteor")
                if not 0.0 <= scores[k] <= 1.0})
    if bad or rescored != scores:
        raise AssertionError(f"evaluate: scores out of range {bad}, or not evaluate_captions' "
                             f"on its captions {rescored}")
    decode_s = eval_s - metric_s
    log(f"evaluate: {EVAL_IMAGES} images x {EVAL_REFS} references, batch {EVAL_BATCH} "
        f"({len(batches)} decode batches, the last {len(chunks[-1])} rows + "
        f"{EVAL_BATCH - len(chunks[-1])} of zeros), resnet50+lstm1 beam {BEAM} vocab {VOCAB} bf16: "
        f"launches {counts}: K2 {counts['lstm_cell'] // len(batches)}, K3 "
        f"{counts['merge_head'] // len(batches)} + {counts['vocab_proj'] // len(batches)} a batch; "
        f"captions identical to generate's")
    log(f"evaluate: {eval_s:.5f} s, {EVAL_IMAGES / eval_s:.2f} captions/s; the metrics' host "
        f"time {metric_s:.5f} s for {', '.join(METRICS)} ({os.cpu_count()} cpus), scored again "
        f"on its captions; evaluate's wall less that {decode_s:.5f} s (the decode, and the host's "
        f"spread between the two scorings); generate alone on the same batches {generate_s:.5f} s "
        f"({EVAL_IMAGES / generate_s:.2f} captions/s)")
    log(f"evaluate: scores { {k: round(v, 6) for k, v in scores.items()} }")
    return batches


def run_bundle(pipe, batch) -> None:
    """7(b): ``save`` then ``load`` on the card: every param leaf bit for bit
    with its dtype, the same captions; ``reload_params`` from the bundle;
    a bundle with another vocabulary refused, the live captions unchanged."""
    import shutil
    import tempfile

    from tpucap_torch.core import tree_leaves
    from tpucap_torch.pipeline import CaptioningPipeline
    from tpucap_torch.text import Tokenizer

    want = pipe.generate(batch)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "bundle"
        _, save_s = timed(lambda: pipe.save(path))
        back, load_s = timed(lambda: CaptioningPipeline.load(path))
        ours, theirs = tree_leaves(pipe.params), tree_leaves(back.params)
        bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t  # noqa: E731
        if len(ours) != len(theirs) or not all(
            a.dtype == b.dtype and b.is_cuda and torch.equal(bits(a), bits(b))
            for a, b in zip(ours, theirs)
        ):
            raise AssertionError("bundle: loaded params differ from the saved ones")
        if back.generate(batch) != want:
            raise AssertionError("bundle: the loaded pipeline's captions differ")
        del back
        pipe.reload_params(path)
        if pipe.generate(batch) != want:
            raise AssertionError("bundle: captions changed after reload_params from the same bundle")
        other = Path(tmp) / "other_vocab"
        shutil.copytree(path, other)
        tok = Tokenizer()
        tok.fit_on_texts(corpus(VOCAB - 4)["corpus"])
        tok.save(other / "tokenizer.json")
        try:
            pipe.reload_params(other)
        except ValueError as e:
            refusal = str(e)
        else:
            raise AssertionError("bundle: reload_params took a bundle with another vocabulary")
        if pipe.generate(batch) != want:
            raise AssertionError("bundle: captions changed after a refused reload_params")
        mib = (path / "params.npz").stat().st_size / 2**20
    log(f"bundle: save {save_s:.5f} s, load on the card {load_s:.5f} s, params.npz {mib:.1f} MiB "
        f"({len(ours)} leaves, {sorted({str(t.dtype) for t in ours})}); params bit-identical, "
        f"captions of batch {BATCH} identical; reload_params from the bundle took it; another "
        f"vocabulary refused ({refusal!r}), live captions unchanged")


def run_fit_validation(pipe) -> None:
    """7(c): ``fit(val_data=...)`` at bench.py --mode train's decoder shapes
    (batch 256, bf16 compute, f32 masters), FIT_TRAIN training rows and
    FIT_VAL validation rows, val_metric bleu4 with early stopping (patience
    1): each epoch's val_loss, val_bleu4 and wall (training and validation,
    from the log's stamps); the validation alone, called once more on the
    last epoch's params, gives that epoch's scores again and its seconds.
    The counters reset just before and read just after fit, so K2 and K3
    count the monitor's greedy decode (training and val_loss run the plain
    loop). Then the monitor's route against its plain version."""
    from tpucap_torch import ops
    from tpucap_torch.config import TrainConfig

    pipe.config = dataclasses.replace(pipe.config, train=TrainConfig(
        batch_size=DEC_TRAIN_BATCH, precision="bf16", val_metric="bleu4", early_stopping_patience=1))
    train = training_corpus(pipe.tokenizer, FIT_TRAIN, 15)
    val = training_corpus(pipe.tokenizer, FIT_VAL, 16, prefix="val")
    feats = random_features([*train, *val], 17)

    stamps, lines = [], []

    def log_line(msg):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        lines.append(msg)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = pipe.fit(train, feats, epochs=FIT_EPOCHS, val_data=(val, feats), log=log_line)
    counts = ops.launch_counts()
    epoch_stamps = [t for t, m in zip(stamps, lines) if m.startswith("epoch ")]
    n = len(hist)
    keys = ("loss", "val_loss", "val_accuracy", "val_bleu4")
    if not 1 <= n <= FIT_EPOCHS or len(epoch_stamps) != n or not all(
        np.isfinite(e[k]) for e in hist for k in keys
    ) or not all(0.0 <= e["val_bleu4"] <= 1.0 for e in hist):
        raise AssertionError(f"fit(val_data): history {hist}")
    if n < FIT_EPOCHS and not lines[-1].startswith(f"early stopping at epoch {n - 1}"):
        raise AssertionError(f"fit(val_data): stopped after {n} epochs, log {lines}")
    decode_batches = -(-FIT_VAL // DEC_TRAIN_BATCH) * n
    k2 = counts["lstm_cell"]
    expect = {name: 0 for name in counts}
    expect.update(lstm_cell=k2, merge_head=k2, vocab_proj=k2)
    if counts != expect or not decode_batches <= k2 <= MAX_LEN * decode_batches:
        raise AssertionError(f"fit(val_data): launch counts {counts}, {decode_batches} decode batches")

    score = pipe._validation((val, feats), DEC_TRAIN_BATCH, torch.bfloat16)
    again, val_s = timed(lambda: score(pipe.params["decoder"]))
    if any(not np.isclose(again[k], hist[-1][k], rtol=1e-5, atol=0) for k in again):
        raise AssertionError(f"fit(val_data): the last epoch's validation {hist[-1]}, again {again}")
    log(f"fit(val_data): lstm1 batch {DEC_TRAIN_BATCH} bf16 compute, {FIT_TRAIN} training rows, "
        f"{FIT_VAL} validation rows, val_metric bleu4, patience 1: {n} of {FIT_EPOCHS} epochs; "
        f"the monitor's greedy decode launched K2 {k2}, K3 {counts['merge_head']} + "
        f"{counts['vocab_proj']} ({decode_batches} decode batches, {k2 / decode_batches:g} steps a batch)")
    for e, end in zip(hist, epoch_stamps):
        log(f"fit(val_data): epoch {e['epoch']}: loss {e['loss']:.6f} val_loss {e['val_loss']:.6f} "
            f"val_accuracy {e['val_accuracy']:.6f} val_bleu4 {e['val_bleu4']:.6g}; "
            f"{end - t0:.5f} s (training and validation)")
        t0 = end
    log(f"fit(val_data): the validation on the last epoch's params, called again: {val_s:.5f} s, "
        f"the same scores")
    if n < FIT_EPOCHS:
        log(f"fit(val_data): {lines[-1]}")
    check_monitor_route(pipe, np.stack([feats[k] for k in list(val)[:DEC_TRAIN_BATCH]]))


def check_monitor_route(pipe, feats, label: str = "monitor route") -> None:
    """A decode route of f32 params against its plain version at one
    batch's rows (``feats``): fit's monitor's DEC_TRAIN_BATCH, or phase 8's
    batches, so K2's f32 kernel and K3's f32 (SIMT) routes. Along the plain
    step's greedy tokens, each step's logits through ``step_fn`` (the fused
    step) against the plain step's on the same state, TF32 off."""
    from tpucap_torch import ops
    from tpucap_torch.core import apply_precision, tree_leaves

    params = pipe.params["decoder"]
    if any(t.dtype != torch.float32 for t in tree_leaves(params)):
        raise AssertionError(f"{label}: the decoder's params are not f32")
    fused = pipe.step_fn()
    apply_precision("f32")
    ops.reset_launch_counts()
    try:
        with torch.inference_mode():
            state = pipe.decoder.init_state(params, torch.as_tensor(feats, device=pipe.device))
            token = torch.full((len(feats),), pipe._token_ids()[0], device=pipe.device)
            err = 0.0
            for t in range(MAX_LEN):
                lk, _ = fused(params, state, token)
                lp, state = pipe.decoder.step(params, state, token)
                # f32 both ways; sums of 256 products in another order.
                check_close(f"{label} step {t}", lk, lp, 1e-5, 1e-4)
                err = max(err, max_err(lk, lp))
                token = lp.argmax(-1)
    finally:
        apply_precision(pipe.config.precision)
    counts = ops.launch_counts()
    if not counts["lstm_cell"] == counts["merge_head"] == counts["vocab_proj"] == MAX_LEN:
        raise AssertionError(f"{label}: launch counts {counts}")
    log(f"{label}: f32, {len(feats)} rows, {MAX_LEN} greedy steps: the fused step's logits "
        f"(K2, K3 f32) within tol 1e-4 + 1e-5 rel of the plain step's, max_abs_err {err:.3g}")


# -- phase 8: the CLI workflow on CONFIG_1 -----------------------------------


class StampedLines(io.TextIOBase):
    """A text stream that keeps each line written with the time it ended."""

    def __init__(self):
        self.lines: list[tuple[float, str]] = []
        self._part = ""

    def write(self, s: str) -> int:
        *done, self._part = (self._part + s).split("\n")
        self.lines += [(time.perf_counter(), line) for line in done]
        return len(s)


def run_cli(argv) -> tuple[list[tuple[float, str]], list[str], float, float]:
    """``tpucap_torch.cli.main.main(argv)`` as a user calls it (on the
    card), its output captured. -> (stdout lines with their times, stderr
    lines, seconds, start time)."""
    from tpucap_torch.cli.main import main as cli

    out, err = StampedLines(), StampedLines()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli([str(a) for a in argv])
    torch.cuda.synchronize()
    return out.lines, [line for _, line in err.lines], time.perf_counter() - t0, t0


def write_cli_dataset(root: Path) -> list[str]:
    """A Flickr8k-format dataset: images/<id>.jpg linking the baseline
    fixtures in turn, tokens.txt (``<id>.jpg#<n>\t<caption>``, CLI_REFS
    captions an image drawn in turn from ``corpus``'s sentences, so the
    training split holds the whole vocabulary) and train.txt, dev.txt,
    test.txt. -> the ids."""
    sentences = [c.removeprefix("startseq ").removesuffix(" endseq")
                 for c in corpus(VOCAB - 3)["corpus"]]
    ids = [f"{i:06d}_{i % 1000:03d}" for i in range(CLI_IMAGES)]
    (root / "images").mkdir()
    for i, k in enumerate(ids):
        os.symlink(FIXTURES / BASELINE_FIXTURES[i % len(BASELINE_FIXTURES)], root / "images" / f"{k}.jpg")
    with open(root / "tokens.txt", "w") as f:
        for i, k in enumerate(ids):
            for n in range(CLI_REFS):
                f.write(f"{k}.jpg#{n}\t{sentences[(i * CLI_REFS + n) % len(sentences)]}\n")
    start = 0
    for name, n in zip(("train", "dev", "test"), CLI_SPLITS):
        (root / f"{name}.txt").write_text("".join(f"{k}.jpg\n" for k in ids[start : start + n]))
        start += n
    return ids


def orbax_keeps(saved, n: int, key: str, maximize: bool) -> tuple[list[int], int]:
    """(steps kept, best step) of orbax 0.11.32's BestN(n) and best_step
    for (step, metrics) saved in step order: after each save beyond n, the
    n best by ``key`` stay; a tie goes to the later step."""
    rank = lambda c: (c[1][key] if maximize else -c[1][key], c[0])  # noqa: E731
    kept: list = []
    for entry in saved:
        kept.append(entry)
        if len(kept) > n:
            best = {c[0] for c in sorted(kept, key=rank)[-n:]}
            kept = [c for c in kept if c[0] in best]
    return [c[0] for c in kept], max(kept, key=rank)[0]


def check_cli_counts(label: str, counts: dict[str, int], decode_batches: int) -> int:
    """K2 and K3's two kernels the same count, one a decode step, at most
    MAX_LEN steps a batch; no other kernel. -> the count."""
    k2 = counts["lstm_cell"]
    expect = {name: 0 for name in counts}
    expect.update(lstm_cell=k2, merge_head=k2, vocab_proj=k2)
    if counts != expect or not decode_batches <= k2 <= MAX_LEN * decode_batches:
        raise AssertionError(f"{label}: launch counts {counts}, {decode_batches} decode batches")
    return k2


def run_cli_workflow(dev, root: Path) -> None:
    """8: extract -> train -> caption -> evaluate on ``--preset config1``,
    each command held to the library calls it stands for, in ``root``
    (phase 18 captions from its checkpoint ``root / "ckpt"``)."""
    from tpucap_torch import ops
    from tpucap_torch.checkpoint import CheckpointManager
    from tpucap_torch.cli.main import _build_config, build_parser
    from tpucap_torch.core import tree_leaves, tree_map
    from tpucap_torch.data import load_descriptions, load_split, prepare_descriptions
    from tpucap_torch.models.encoders import build_encoder
    from tpucap_torch.pipeline import CaptioningPipeline
    from tpucap_torch.text import load_tokenizer
    from tpucap_torch.train import TrainState, build_optimizer
    from tpucap_torch.train.evaluate import METRICS, evaluate_captions

    preset = list(CLI_MODEL)
    ids = write_cli_dataset(root)
    feats_path, ckpt = root / "features.npz", root / "ckpt"
    paths = [root / "images" / f"{k}.jpg" for k in ids]
    cfg = _build_config(build_parser()[0].parse_args(["extract", *preset, "--images", "-", "--out", "-"]))
    log(f"cli: {' '.join(preset)}: {cfg.encoder.name} {cfg.encoder.features} {cfg.encoder.feature_dim}-d "
        f"at {build_encoder(cfg.encoder.name).input_size}, {cfg.decoder.name} embed {cfg.decoder.embed_dim} hidden {cfg.decoder.hidden_dim}, "
        f"max_len {cfg.decode.max_len}, precision {cfg.precision}; {CLI_IMAGES} images (the six "
        f"baseline fixtures in turn), {CLI_REFS} captions each, splits {CLI_SPLITS}")

    # (a) extract
    ops.reset_launch_counts()
    out, err, extract_s, _ = run_cli(["extract", *preset, "--images", root / "images", "--out",
                                      feats_path, "--batch-size", CLI_EXTRACT_BATCH])
    counts = ops.launch_counts()
    if [line for _, line in out] != [f"wrote {CLI_IMAGES} features to {feats_path}"] or any(counts.values()):
        raise AssertionError(f"cli extract: printed {out}, launches {counts}")
    with np.load(feats_path) as z:
        feats = {k: z[k] for k in z.files}
    pipe = CaptioningPipeline(cfg, device=dev)
    pipe.build()
    want, lib_s = timed(lambda: pipe.extract_features(paths, batch_size=CLI_EXTRACT_BATCH))
    if sorted(feats) != sorted(ids) or not all(
        feats[k].dtype == np.float32 and np.array_equal(feats[k], w) for k, w in zip(ids, want)
    ) or not np.isfinite(want).all():
        raise AssertionError("cli extract: the rows differ from extract_features' on the same weights")
    log(f"cli extract: {CLI_IMAGES} rows of {want.shape[1]}, bit for bit extract_features' on the same "
        f"weights; the command {extract_s:.5f} s ({CLI_IMAGES / extract_s:.2f} images/s, VGG16's "
        f"random build included), extract_features alone {lib_s:.5f} s "
        f"({CLI_IMAGES / lib_s:.2f} images/s, host decode and resize included); no kernel launched")

    # (b) train; each save's params kept aside to hold the restores to.
    saved: dict[int, list] = {}
    real_save = CheckpointManager.save

    def keep(self, state, metrics=None):
        saved[int(state.step)] = [t.detach().cpu().clone() for t in tree_leaves(state.params)]
        return real_save(self, state, metrics)

    mlog = root / "metrics.jsonl"
    ops.reset_launch_counts()
    CheckpointManager.save = keep
    try:
        out, err, train_s, t0 = run_cli([
            "train", *preset, "--tokens", root / "tokens.txt", "--split", root / "train.txt",
            "--val-split", root / "dev.txt", "--val-metric", "bleu4", "--early-stopping-patience", 1,
            "--epochs", CLI_EPOCHS, "--batch-size", CLI_TRAIN_BATCH, "--features", feats_path,
            "--checkpoint-dir", ckpt, "--metrics-log", mlog])
    finally:
        CheckpointManager.save = real_save
    counts = ops.launch_counts()
    hist = [json.loads(line) for line in mlog.read_text().splitlines()]
    n = len(hist)
    steps_per_epoch = CLI_SPLITS[0] * CLI_REFS // CLI_TRAIN_BATCH
    steps = [steps_per_epoch * (e + 1) for e in range(n)]
    epoch_lines = [(t, line) for t, line in out if line.startswith("epoch ")]
    if not 1 <= n <= CLI_EPOCHS or sorted(saved) != steps or len(epoch_lines) != n or not out[-1][1].startswith(
        f"trained {n} epochs; final loss {hist[-1]['loss']:.4f}; checkpoints in {ckpt}"
    ) or not all(np.isfinite(e[k]) for e in hist for k in ("loss", "val_loss", "val_bleu4")):
        raise AssertionError(f"cli train: printed {out}, saved steps {sorted(saved)}, history {hist}")
    k2 = check_cli_counts("cli train", counts, n * -(-CLI_SPLITS[1] // CLI_TRAIN_BATCH))
    mgr = CheckpointManager(ckpt, best_metric="val_bleu4", best_mode="max")
    kept, best = orbax_keeps([(s, e) for s, e in zip(steps, hist)], 3, "val_bleu4", maximize=True)
    if mgr.all_steps() != kept or mgr.best_step() != best or any(
        mgr.metrics(s) != {"val_loss": hist[i]["val_loss"], "val_bleu4": hist[i]["val_bleu4"]}
        for i, s in enumerate(steps) if s in kept
    ):
        raise AssertionError(f"cli train: kept {mgr.all_steps()} best {mgr.best_step()}, orbax's rules "
                             f"give {kept} best {best}")
    tok = load_tokenizer(ckpt / "tokenizer.json")
    ref = CaptioningPipeline(cfg, tokenizer=tok, device=dev)
    ref.build(init_params=False)
    template = TrainState.create(tree_to(ref.decoder.init(torch.Generator()), dev),
                                 build_optimizer(cfg.train), torch.Generator(device=dev))
    for s in kept:
        back = tree_leaves(mgr.restore(template, s).params)
        if not all(b.dtype == a.dtype and torch.equal(b.cpu(), a) for a, b in zip(saved[s], back)):
            raise AssertionError(f"cli train: step {s} restored differs from the saved params")
    if ref.vocab_size != VOCAB:
        raise AssertionError(f"cli train: vocabulary {ref.vocab_size} != {VOCAB}")
    log(f"cli train: {CLI_SPLITS[0]} x {CLI_REFS} captions, batch {CLI_TRAIN_BATCH} ({steps_per_epoch} steps "
        f"an epoch), f32, vocab {ref.vocab_size}, dev split {CLI_SPLITS[1]} ids, val_metric bleu4, "
        f"patience 1: {n} of {CLI_EPOCHS} epochs, {train_s:.5f} s in all; saved steps {steps}, kept "
        f"{kept}, best {best} (orbax's rules on the logged val_bleu4); each kept step restored bit for "
        f"bit; the monitor's greedy decode launched K2 {k2}, K3 {counts['merge_head']} + "
        f"{counts['vocab_proj']}")
    last = t0
    for e, (t, line) in zip(hist, epoch_lines):
        log(f"cli train: epoch {e['epoch']}: loss {e['loss']:.6f} val_loss {e['val_loss']:.6f} val_bleu4 "
            f"{e['val_bleu4']:.6g}; {t - last:.5f} s since the "
            f"{'command started (setup included)' if last == t0 else 'last epoch line'}")
        last = t

    # (c) caption, against caption_images on the best step's params
    ref.set_params({"encoder": pipe.params["encoder"], "decoder": mgr.restore(template, best).params})
    del pipe
    # The f32 routes on these params at the rows the commands below
    # decode: caption's CLI_CAPTIONED images x beam BEAM, and evaluate's
    # (and the train monitor's) greedy batch of CLI_TRAIN_BATCH.
    check_monitor_route(ref, np.repeat(np.stack([feats[k] for k in ids[:CLI_CAPTIONED]]), BEAM, axis=0),
                        "cli caption route")
    check_monitor_route(ref, np.stack([feats[k] for k in ids[-CLI_SPLITS[2]:]]), "cli evaluate route")
    picked = paths[:CLI_CAPTIONED]
    ops.reset_launch_counts()
    out, err, caption_s, _ = run_cli(["caption", *preset, "--image", *picked, "--checkpoint-dir", ckpt,
                                      "--val-metric", "bleu4"])
    counts = ops.launch_counts()
    steps_c = check_cli_counts("cli caption", counts, 1)
    want = [f"{p}\t{c}" for p, c in zip(picked, ref.caption_images(picked, method="beam", beam_width=BEAM))]
    if [line for _, line in out] != want or not err[0].startswith("note: no --keras-h5 given"):
        raise AssertionError(f"cli caption: printed {out} {err}, caption_images gives {want}")
    log(f"cli caption: {CLI_CAPTIONED} images, beam {BEAM}: the lines of caption_images on the best step; "
        f"{caption_s:.5f} s (VGG16's random build and the restore included); launches {counts}: "
        f"K2 {steps_c}, K3 {counts['merge_head']} + {counts['vocab_proj']} ({steps_c} decode steps)")
    for _, line in out[:2]:
        log(f"cli caption: {line!r}")

    # (d) evaluate, against pipe.evaluate on the same params
    coco = root / "coco.json"
    ops.reset_launch_counts()
    out, err, eval_s, _ = run_cli([
        "evaluate", *preset, "--tokens", root / "tokens.txt", "--split", root / "test.txt",
        "--features", feats_path, "--checkpoint-dir", ckpt, "--val-metric", "bleu4", "--batch-size",
        CLI_TRAIN_BATCH, "--metrics", ",".join(METRICS), "--coco-results", coco])
    counts = ops.launch_counts()
    steps_e = check_cli_counts("cli evaluate", counts, 1)
    scores = json.loads(out[-1][1])
    test = prepare_descriptions(load_descriptions(root / "tokens.txt"), load_split(root / "test.txt"))
    (want_scores, caps), lib_s = timed(lambda: ref.evaluate(
        test, feats, batch_size=CLI_TRAIN_BATCH, metrics=METRICS, return_captions=True))
    _, decode_s = timed(lambda: ref.generate(np.stack([feats[k] for k in test])))
    _, metric_s = timed(lambda: evaluate_captions(test, caps, metrics=METRICS))
    rows = json.loads(coco.read_text())
    bad = {k: v for k, v in scores.items() if v is not None and not np.isfinite(v)}
    bad.update({k: scores[k] for k in ("bleu1", "bleu2", "bleu3", "bleu4", "rouge_l", "meteor")
                if not 0.0 <= scores[k] <= 1.0})
    if scores != want_scores or bad or rows != [{"image_id": k, "caption": c} for k, c in caps.items()] \
            or err != [f"wrote {len(test)} coco-format results to {coco}"]:
        raise AssertionError(f"cli evaluate: scores {scores} ({bad} out of range), evaluate gives "
                             f"{want_scores}; printed {err}")
    log(f"cli evaluate: {len(test)} test images x {CLI_REFS} references, greedy, batch {CLI_TRAIN_BATCH}, "
        f"every metric: pipe.evaluate's scores on the best step; the command {eval_s:.5f} s (VGG16's "
        f"random build and the restore included), pipe.evaluate {lib_s:.5f} s, its decode alone "
        f"{decode_s:.5f} s, the metrics' host time {metric_s:.5f} s; launches {counts}: K2 {steps_e}, "
        f"K3 {counts['merge_head']} + {counts['vocab_proj']}")
    log(f"cli evaluate: scores { {k: (round(v, 6) if v is not None else None) for k, v in scores.items()} }")

    # (e) a refused flag exits before any restore
    absent = root / "absent"
    try:
        run_cli(["export", *preset, "--checkpoint-dir", absent, "--out", absent / "d", "--format", "aot"])
    except SystemExit as e:
        refusal = e.code
    else:
        raise AssertionError("cli: export --format aot ran")
    if refusal in (0, None) or "--format aot" not in str(refusal) or absent.exists():
        raise AssertionError(f"cli: export --format aot exited with {refusal!r}")
    log(f"cli: export --format aot exits before any restore: {refusal!r}")



# -- phase 9: CONFIG_2, CONFIG_4 and CONFIG_5 --------------------------------

# CONFIG_2's serving batch at InceptionV3's 299 and CONFIG_4's at 224; the
# n-gram size of the ban; CONFIG_5's fit rows and epochs (8 steps an epoch
# at its batch 256) and CONFIG_4's (4 steps at its batch 64).
P9_IMAGES, P9_ATT_IMAGES, P9_NGRAM = 256, 64, 3
P9_FIT5_ROWS, P9_FIT5_EPOCHS, P9_FIT4_ROWS = 2048, 2, 256
# The decode routes' tolerance on a logit: atol + rtol * |logit|.
ROUTE_ATOL, ROUTE_RTOL = 1e-4, 1e-5


def preset_pipeline(preset: str, tokenizer, **decoder):
    """``PRESETS[preset]`` as a user builds it (random weights from the
    config seed, BN folded) on ``tokenizer``'s vocabulary; ``decoder``
    overrides DecoderConfig fields."""
    from tpucap_torch.config import PRESETS
    from tpucap_torch.pipeline import CaptioningPipeline

    cfg = PRESETS[preset]
    if decoder:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **decoder))
    pipe = CaptioningPipeline(cfg, tokenizer=tokenizer)
    pipe.build()
    pipe.fold_bn()
    return pipe


def check_counts(label: str, counts: dict[str, int], preprocess: int, decode: bool) -> int:
    """K1 ``preprocess`` times; with ``decode``, K2 and K3's two kernels the
    same count, one a step, 1 to MAX_LEN steps; no other kernel. -> steps."""
    steps = counts["lstm_cell"]
    expect = {name: 0 for name in counts}
    expect["preprocess_u8"] = preprocess
    if decode:
        expect.update(lstm_cell=steps, merge_head=steps, vocab_proj=steps)
    if counts != expect or (decode and not 1 <= steps <= MAX_LEN):
        raise AssertionError(f"{label}: launch counts {counts}, expected {expect}")
    return steps


def _repeats(caption: str, n: int) -> bool:
    words = caption.split()
    grams = [tuple(words[i : i + n]) for i in range(len(words) - n + 1)]
    return len(grams) != len(set(grams))


def decode_agreement(pipe, feats, method: str, label: str) -> None:
    """The fused step (K2's f32 kernel, K3's f32 routes) against the plain
    step from the same features, TF32 off. (1) Along the fused decode each
    step's logits within ROUTE_ATOL + ROUTE_RTOL * |x| of the plain step's
    on the same state. (2) The plain decode alone, recording for each image
    whether any of its decisions was a near-tie: a selection boundary
    within the routes' error, between a beam's k-th and (k + 1)-th logits
    (2 tol), an image's k-th and (k + 1)-th of its k * k candidate scores at
    step t (4 tol (t + 1): each score sums t + 1 log-probs), its two best
    length-normalized finals (4 tol MAX_LEN), or greedy's two best logits
    (2 tol); tol at the largest |logit| seen. (3) Every image without a
    near-tie gets the same tokens from both decodes. Beside it the log
    counts the images with a gap within the error the run measured
    (max_abs_err), where a difference could really arise."""
    from tpucap_torch.core import apply_precision
    from tpucap_torch.decode import beam as beam_mod
    from tpucap_torch.decode import greedy as greedy_mod
    from tpucap_torch.decode.beam import normalized_scores
    from tpucap_torch.ops.decoder_step import make_fused_merge_step

    params = pipe.params["decoder"]
    fused, plain = make_fused_merge_step(pipe.decoder), pipe.decoder.step
    B, k = len(feats), (BEAM if method == "beam" else 1)
    seen = {"err": 0.0, "scale": 0.0, "step": 0, "stage2": 0}

    def lockstep(p, state, token):
        lk, new = fused(p, state, token)
        lp, _ = plain(p, state, token)
        check_close(f"{label}: step {seen['step']}", lk, lp, ROUTE_RTOL, ROUTE_ATOL)
        seen["err"] = max(seen["err"], max_err(lk, lp))
        seen["scale"] = max(seen["scale"], float(lp.abs().max()))
        seen["step"] += 1
        return lk, new

    # Per image, the smallest decision gap over its error factor: a near-tie
    # where that is within tol (and, reported beside it, within the error
    # the run measured).
    ratio = torch.full((B,), float("inf"))
    real_topk, real_floor = beam_mod.topk_stable, greedy_mod.min_len_mask

    def gaps(x, n):
        """The gap at the selection's boundary: n-th best against (n+1)-th."""
        top = torch.topk(x.float(), n + 1, dim=-1).values
        return (top[..., n - 1] - top[..., n]).cpu()

    def note(per_image):
        torch.minimum(ratio, per_image, out=ratio)

    def topk(x, n):
        if x.shape[0] == B * k:  # stage 1: each beam's logits
            note((gaps(x, n) / 2).reshape(B, k).amin(dim=1))
        else:  # stage 2: an image's candidate scores, sums of t + 1 log-probs
            seen["stage2"] += 1
            note(gaps(x, n) / (4 * seen["stage2"]))
        return real_topk(x, n)

    def floor(masked, t, min_len, end_id):
        masked = real_floor(masked, t, min_len, end_id)
        note(gaps(masked, 1) / 2)
        return masked

    # TF32 off: the pipeline's decode runs under its own config's flags
    # (``CaptioningPipeline._decode``), so the config says f32 here.
    config = pipe.config
    pipe.config = dataclasses.replace(config, precision="f32")
    apply_precision("f32")
    pipe.step_fn = lambda: lockstep
    try:
        with torch.inference_mode():
            x = torch.as_tensor(feats, device=pipe.device)
            got = pipe._decode(params, x, method, BEAM)
            pipe.step_fn = lambda: plain
            beam_mod.topk_stable, greedy_mod.min_len_mask = topk, floor
            try:
                want = pipe._decode(params, x, method, BEAM)
            finally:
                beam_mod.topk_stable, greedy_mod.min_len_mask = real_topk, real_floor
    finally:
        del pipe.step_fn
        pipe.config = config
        apply_precision(pipe.config.precision)
    tol = ROUTE_ATOL + ROUTE_RTOL * seen["scale"]
    if method == "beam":
        d = pipe.config.decode
        norm = normalized_scores(want.beam_scores, want.beam_lengths, length_normalize=d.length_normalize,
                                 alpha=d.alpha, length_penalty=d.length_penalty)
        note(gaps(norm, 1) / (4 * MAX_LEN))
    near, close = ratio <= tol, ratio <= seen["err"]
    same = (got.tokens == want.tokens).all(dim=1).cpu()
    if not bool((same | near).all()):
        bad = torch.nonzero(~(same | near))[:, 0].tolist()
        raise AssertionError(f"{label}: images {bad} decode to other tokens with no near-tie")
    log(f"{label}: f32 (TF32 off), {B} images x {k}: the fused step's logits within tol {ROUTE_ATOL:g} + "
        f"{ROUTE_RTOL:g} rel of the plain step's at every step, max_abs_err {seen['err']:.3g}; tokens "
        f"identical on {int(same.sum())}/{B} images; {int(near.sum())} with a near-tie within tol "
        f"({tol:.3g} at |logit| {seen['scale']:.3g}), {int(close.sum())} within the measured error; "
        f"{int((~same).sum())} different, each with a near-tie")


def run_config2(dev, tokenizer) -> tuple[dict[str, int], torch.Tensor]:
    """9(a, b): CONFIG_2's ``caption_batch`` at 299 (tf mode, K1; InceptionV3
    pooled; lstm1 beam 3 through K2 and K3's f32 routes, "mixed" keeping
    the params f32), held to the plain step; then with
    ``no_repeat_ngram_size`` P9_NGRAM, greedy and beam. -> (the launches
    of the counted runs, the batch's features)."""
    from tpucap_torch import ops
    from tpucap_torch.ops.preprocess import fused_preprocess

    from tpucap_torch.decode.ngram import apply_ngram_ban

    pipe = preset_pipeline("config2", tokenizer)
    enc = pipe.encoder
    g = torch.Generator(device=dev).manual_seed(9)
    images = torch.randint(0, 256, (P9_IMAGES, enc.input_size, enc.input_size, 3), generator=g,
                           device=dev, dtype=torch.uint8)

    def encode():
        with torch.inference_mode():
            x = fused_preprocess(images, enc.input_size, enc.preprocess_mode, out_dtype=torch.float32)
            return pipe._apply_encoder(pipe._inference_params()["encoder"], x)

    feats = encode()
    if feats.shape != (P9_IMAGES, 2048) or not torch.isfinite(feats).all():
        raise AssertionError(f"config2: features {tuple(feats.shape)} not finite/expected")
    # Random InceptionV3 features of noise images differ by about 1e-3 of
    # their mean, so every image would get one caption: the image branch is
    # centred on the batch's mean feature and scaled 300 times, and the
    # decodes differ by image. Random logits lie within about 0.01 of each
    # other over 7579 words, every decision a near-tie: the head sharpened
    # 1000 times spreads them over about ten units, so the agreement checks
    # decisions that are not ties.
    dec = pipe.params["decoder"]
    dec["feat_proj"]["kernel"].mul_(300.0)
    dec["feat_proj"]["bias"].copy_(-(feats.mean(dim=0) @ dec["feat_proj"]["kernel"]))
    dec["out"]["kernel"].mul_(1000.0)
    pipe.caption_batch(images)  # warm-up: cuDNN plans, allocator
    enc_s = min(timed(encode)[1] for _ in range(2))
    total = {name: 0 for name in ops.launch_counts()}
    for method, n in (("beam", 0), ("greedy", P9_NGRAM), ("beam", P9_NGRAM)):
        pipe.config = dataclasses.replace(pipe.config, decode=dataclasses.replace(
            pipe.config.decode, no_repeat_ngram_size=n))
        ops.reset_launch_counts()
        caps, s = timed(lambda: pipe.caption_batch(images, method=method))
        counts = ops.launch_counts()
        label = f"config2 {method}" + (f" no_repeat_ngram_size={n}" if n else "")
        steps = check_counts(label, counts, 1, decode=True)
        total = {name: total[name] + c for name, c in counts.items()}
        if len(caps) != P9_IMAGES or (n and any(_repeats(c, n) for c in caps)):
            raise AssertionError(f"{label}: {len(caps)} captions, a repeated {n}-gram in "
                                 f"{[c for c in caps if n and _repeats(c, n)][:2]}")
        log(f"{label}: {P9_IMAGES} images at {enc.input_size} (tf), inception_v3 pooled + lstm1 "
            f"{pipe.config.decoder.hidden_dim}, vocab {pipe.vocab_size}, precision {pipe.config.precision}: "
            f"caption_batch {s:.5f} s ({P9_IMAGES / s:.2f} captions/s), preprocess+encoder {enc_s:.5f} s, "
            f"the decode {s - enc_s:.5f} s over {steps} steps ({(s - enc_s) * 1e3 / steps:.3f} ms a step); "
            f"launches K1 {counts['preprocess_u8']}, K2 {steps}, K3 {counts['merge_head']} + "
            f"{counts['vocab_proj']}; {len(set(caps))} distinct captions; {caps[0]!r}")
        decode_agreement(pipe, feats, method, label)
    pipe.config = dataclasses.replace(pipe.config, decode=dataclasses.replace(
        pipe.config.decode, no_repeat_ngram_size=0))
    # The ban's device time a step: a full history of MAX_LEN tokens, on the
    # beam's and greedy's rows.
    for rows in (P9_IMAGES * BEAM, P9_IMAGES):
        hist = torch.randint(1, pipe.vocab_size, (rows, MAX_LEN), generator=g, device=dev)
        logits = torch.randn((rows, pipe.vocab_size), generator=g, device=dev)
        log(f"config2: the ban (n = {P9_NGRAM}) on {rows} rows x {pipe.vocab_size}, history {MAX_LEN}: "
            f"{cuda_ms(lambda: apply_ngram_ban(logits, hist, MAX_LEN - 1, P9_NGRAM)):.4f} ms (device)")
    return total, feats


def run_inject(dev, tokenizer, feats) -> None:
    """9(c): ``--decoder inject`` on CONFIG_2's InceptionV3 features: one
    beam-3 ``generate`` of the batch, through the plain step (no kernel)."""
    from tpucap_torch import ops

    pipe = preset_pipeline("config2", tokenizer, name="inject")
    f = feats.float().cpu().numpy()
    pipe.generate(f[:8])  # warm-up
    ops.reset_launch_counts()
    caps, s = timed(lambda: pipe.generate(f))
    check_counts("inject", ops.launch_counts(), 0, decode=False)
    if len(caps) != len(f) or not all(isinstance(c, str) for c in caps):
        raise AssertionError("inject: generate returned a malformed batch")
    log(f"inject: {len(f)} images, inception_v3 features, InjectDecoder {pipe.config.decoder.hidden_dim}, "
        f"beam {BEAM}: generate {s:.5f} s ({len(f) / s:.2f} captions/s), plain step, no kernel launched; "
        f"{len(set(caps))} distinct captions; {caps[0]!r}")


def run_config4(dev, tokenizer) -> dict[str, int]:
    """9(d): CONFIG_4's ``caption_batch`` at 224 (caffe mode, K1; VGG16's
    14 x 14 x 512 grid; the attention decoder, beam 3, plain step), the
    grids kept (B, 196, .) inside the beam's steps; then ``fit`` on spatial
    features at ``attention_reg=1.0``. -> the counted run's launches."""
    from tpucap_torch import ops
    from tpucap_torch.config import TrainConfig

    from tpucap_torch.ops.preprocess import fused_preprocess

    pipe = preset_pipeline("config4", tokenizer)
    enc, dec = pipe.encoder, pipe.decoder
    g = torch.Generator(device=dev).manual_seed(10)
    images = torch.randint(0, 256, (P9_ATT_IMAGES, enc.input_size, enc.input_size, 3), generator=g,
                           device=dev, dtype=torch.uint8)

    def encode():
        with torch.inference_mode():
            x = fused_preprocess(images, enc.input_size, enc.preprocess_mode, out_dtype=torch.float32)
            return pipe._apply_encoder(pipe._inference_params()["encoder"], x)

    pipe.caption_batch(images[:8])  # warm-up
    encode()
    enc_s = min(timed(encode)[1] for _ in range(2))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    caps, s = timed(lambda: pipe.caption_batch(images))
    counts = ops.launch_counts()
    check_counts("config4", counts, 1, decode=False)
    peak = torch.cuda.max_memory_allocated() / 2**20
    L = enc.spatial_positions
    shapes, steps = set(), []

    def observe(p, state, token):
        shapes.add((tuple(state["features"].shape), tuple(state["att_feat"].shape), tuple(state["h"].shape)))
        steps.append(1)
        return dec.step(p, state, token)

    pipe.step_fn = lambda: observe
    try:
        again = pipe.caption_batch(images)
    finally:
        del pipe.step_fn
    grid, att, h = ((P9_ATT_IMAGES, L, 512), (P9_ATT_IMAGES, L, pipe.config.decoder.attention_dim),
                    (P9_ATT_IMAGES * BEAM, pipe.config.decoder.hidden_dim))
    if shapes != {(grid, att, h)} or again != caps or len(caps) != P9_ATT_IMAGES:
        raise AssertionError(f"config4: state shapes in the beam {shapes}, expected {(grid, att, h)}")
    log(f"config4: {P9_ATT_IMAGES} images at {enc.input_size} (caffe), vgg16 spatial {L} x 512 + attention "
        f"(attention_dim {pipe.config.decoder.attention_dim}), beam {BEAM}: caption_batch {s:.5f} s "
        f"({P9_ATT_IMAGES / s:.2f} captions/s), preprocess+encoder {enc_s:.5f} s, the decode "
        f"{s - enc_s:.5f} s over {len(steps)} steps ({(s - enc_s) * 1e3 / len(steps):.3f} ms a step), "
        f"peak memory {peak:.1f} MiB; launches K1 1, no other kernel "
        f"(plain step); inside every step features {grid} and att_feat {att} beside h {h} (beam-shared, "
        f"untiled); {len(set(caps))} distinct captions; {caps[0]!r}")

    pipe.config = dataclasses.replace(pipe.config, train=TrainConfig(attention_reg=1.0))
    train = training_corpus(tokenizer, P9_FIT4_ROWS, 18)
    rng = np.random.default_rng(19)
    feats = {k: np.maximum(rng.normal(size=(L, 512)), 0).astype(np.float32) for k in train}
    ops.reset_launch_counts()
    hist, fit_s = timed(lambda: pipe.fit(train, feats, epochs=1, log=None))
    check_counts("config4 fit", ops.launch_counts(), 0, decode=False)
    e = hist[0]
    if not all(np.isfinite(e[k]) for k in ("loss", "attention_reg")) or not e["attention_reg"] > 0:
        raise AssertionError(f"config4 fit: history {hist}")
    steps = P9_FIT4_ROWS // pipe.config.train.batch_size
    log(f"config4 fit: {P9_FIT4_ROWS} rows of {L} x 512 spatial features, batch "
        f"{pipe.config.train.batch_size} ({steps} steps), f32, attention_reg 1.0: loss {e['loss']:.6f}, "
        f"attention_reg {e['attention_reg']:.6f}, perplexity {e['perplexity']:.4f}; {fit_s:.5f} s "
        f"({fit_s * 1e3 / steps:.1f} ms a step, setup included); no kernel launched")
    return counts


def run_config5_fit(dev, tokenizer) -> None:
    """9(e): CONFIG_5's ``fit`` on 2048-d features at its batch 256: each
    epoch's loss and seconds (from the log's stamps); no kernel."""
    from tpucap_torch import ops

    pipe = preset_pipeline("config5", tokenizer)
    train = training_corpus(tokenizer, P9_FIT5_ROWS, 20)
    feats = random_features(train, 21)
    stamps = []

    def log_line(msg):
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), msg))

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = pipe.fit(train, feats, epochs=P9_FIT5_EPOCHS, log=log_line)
    check_counts("config5 fit", ops.launch_counts(), 0, decode=False)
    ends = [t for t, m in stamps if m.startswith("epoch ")]
    if len(hist) != P9_FIT5_EPOCHS or len(ends) != len(hist) or not all(np.isfinite(e["loss"]) for e in hist):
        raise AssertionError(f"config5 fit: history {hist}")
    b = pipe.config.train.batch_size
    for e, end in zip(hist, ends):
        log(f"config5 fit: epoch {e['epoch']}: {P9_FIT5_ROWS // b} steps of batch {b}, f32: loss "
            f"{e['loss']:.6f} accuracy {e['accuracy']:.6f}; {end - t0:.5f} s"
            f"{' (setup included)' if e['epoch'] == 0 else ''}")
        t0 = end


def run_presets(dev, tokenizer) -> dict[str, int]:
    """9: the other presets at their published widths. -> the launches of
    the counted serving runs (K1, K2, K3)."""
    t0 = time.perf_counter()
    counts, feats = run_config2(dev, tokenizer)
    run_inject(dev, tokenizer, feats)
    del feats
    c4 = run_config4(dev, tokenizer)
    counts = {name: counts[name] + c4[name] for name in counts}
    run_config5_fit(dev, tokenizer)
    log(f"phase 9: {time.perf_counter() - t0:.2f} s")
    return counts


# -- phase 10: fine-tuning's dials and the CLI's fine-tune path --------------

# (a) the joint step's encoder (phase 5's), the shift of the augmented
# setting and the lr of the plain-SGD steps whose updates give back the
# gradients; (b) the CLI's training split (cut from phase 8's 384 ids),
# epochs, checkpoint interval and shift.
P10_VIT, P10_SHIFT, P10_SGD_LR = "vit_b16", 16, 1e6
FT_CLI_TRAIN_IDS, FT_CLI_EPOCHS, FT_CLI_EVERY, FT_CLI_SHIFT = 128, 2, 4, 8


@contextlib.contextmanager
def deterministic_torch(label: str):
    """torch's deterministic settings in this process while phase 10 runs:
    cuDNN's deterministic algorithms without autotuning, and every op that
    has a deterministic implementation takes it (the others warn, and the
    distinct warnings are logged). The package sets none of this."""
    import warnings

    import torch.utils.deterministic as det

    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    # No NaN fill of every torch.empty: nothing here reads memory it did
    # not write (phase 2d checks the kernels' outputs element by element).
    det.fill_uninitialized_memory = False
    log(f"{label}: torch's deterministic settings on in this process (cudnn.deterministic, no cudnn "
        f"benchmark, use_deterministic_algorithms warn_only, no fill of uninitialized memory)")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(prev[2], warn_only=prev[3])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[0], prev[1]
        det.fill_uninitialized_memory = prev[4]
        seen = sorted({str(w.message).split("\n")[0][:160] for w in caught})
        log(f"{label}: deterministic settings off; {len(caught)} warnings, distinct: {seen}")


def finetune_dials(dev, tokenizer) -> dict[str, int]:
    """10(a): one joint step (ViT-B/16 flash + lstm1, batch TRAIN_BATCH,
    bf16, dropout off) from one state in four settings: plain, remat,
    accumulation over 2 microbatches, augmented. Launches a step, remat's
    params against plain's bit for bit, accumulation's gradients against
    plain's (each setting's step under plain SGD), peak memory and step ms.
    -> the counted steps' launches."""
    from tpucap_torch import ops
    from tpucap_torch.config import Config, DecodeConfig, DecoderConfig, TrainConfig, encoder_config
    from tpucap_torch.core import apply_precision, tree_leaves
    from tpucap_torch.data.augment import make_augment_fn
    from tpucap_torch.pipeline import CaptioningPipeline
    from tpucap_torch.train import (
        TrainState,
        build_optimizer,
        build_training_tokens,
        encoder_learning_rate_optimizer,
        make_joint_train_step,
    )
    from tpucap_torch.train.loop import chain, scale_by_learning_rate

    cfg = Config(encoder=encoder_config(P10_VIT), decoder=DecoderConfig(name="lstm1", embed_dim=WIDTH, hidden_dim=WIDTH),
                 decode=DecodeConfig(max_len=MAX_LEN), train=TrainConfig(batch_size=TRAIN_BATCH, precision="bf16"),
                 precision="bf16")
    pipe = CaptioningPipeline(cfg, tokenizer=tokenizer, device=dev)
    pipe.encoder = dataclasses.replace(pipe.encoder, attention_impl="flash")
    pipe.build(seed=0)
    apply_precision("bf16")  # fit_finetune's training policy at bf16
    size, layers = pipe.encoder.input_size, pipe.encoder.num_layers
    desc = training_corpus(tokenizer, TRAIN_BATCH, 13)
    _, tokens = build_training_tokens(tokenizer, desc, MAX_LEN)
    tokens = torch.from_numpy(tokens).to(dev).long()
    g = torch.Generator(device=dev).manual_seed(14)
    images = torch.rand((TRAIN_BATCH, size, size, 3), generator=g, device=dev) * 2 - 1
    params = {"encoder": pipe.params["encoder"], "decoder": pipe.params["decoder"]}
    adam = encoder_learning_rate_optimizer(build_optimizer(cfg.train), encoder_lr_scale=0.1)
    start = TrainState.create(params, adam, None)
    aug = f"augment (flip, shift {P10_SHIFT})"
    settings = {
        "plain": ({}, (1, 1, 1)),
        "remat": (dict(remat_encoder=True), (2, 1, 1)),
        "accum 2": (dict(grad_accum_steps=2), (2, 2, 2)),
        aug: (dict(augment_fn=make_augment_fn(flip=True, max_shift=P10_SHIFT)), (1, 1, 1)),
    }
    kernels = ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    total = dict.fromkeys(ops.launch_counts(), 0)
    plain_params = None
    for name, (kw, per_layer) in settings.items():
        step = make_joint_train_step(pipe.encoder, pipe.decoder, adam, deterministic=True,
                                     compute_dtype=torch.bfloat16, **kw)

        def run():
            # The augmented setting draws from the state's generator: the
            # same draws each call.
            return step(dataclasses.replace(start, rng=torch.Generator(device=dev).manual_seed(15)), images, tokens)

        run()  # warm-up: allocator, cuBLAS, cuDNN
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resting = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        (new, m), _ = timed(run)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        expect = dict.fromkeys(counts, 0)
        expect.update({k: n * layers for k, n in zip(kernels, per_layer)})
        if counts != expect or not np.isfinite(float(m["loss"])):
            raise AssertionError(f"finetune dials {name}: launches {counts} != {expect}, loss {float(m['loss'])}")
        total = {k: total[k] + counts[k] for k in total}
        leaves = [t.detach().cpu() for t in tree_leaves(new.params)]
        del new
        if name == "plain":
            plain_params, plain_loss = leaves, float(m["loss"])
        elif name == "remat":
            same = all(torch.equal(a, b) for a, b in zip(plain_params, leaves))
            worst = max(max_err(a, b) for a, b in zip(plain_params, leaves))
            if not same or float(m["loss"]) != plain_loss:
                raise AssertionError(f"finetune dials remat: params differ from plain's by up to {worst}, "
                                     f"loss {float(m['loss'])} against {plain_loss}")
        times = [timed(run)[1] for _ in range(5)]
        log(f"finetune dials: {P10_VIT} flash + lstm1, batch {TRAIN_BATCH}, bf16, {name}: step ms "
            f"{[round(t * 1e3, 3) for t in times]} median {np.median(times) * 1e3:.3f}; peak memory "
            f"{peak / 2**30:.3f} GiB ({(peak - resting) / 2**30:.3f} over the resting "
            f"{resting / 2**30:.3f}); launches a step { {k: v for k, v in counts.items() if v} }; loss "
            f"{float(m['loss']):.6f}" + ("; params equal plain's bit for bit" if name == "remat" else ""))
    del plain_params
    aug_fn = settings[aug][0]["augment_fn"]
    gen = torch.Generator(device=dev).manual_seed(15)
    aug_times = [timed(lambda: aug_fn(images, gen))[1] for _ in range(6)][1:]
    log(f"finetune dials: the augmentation alone ({TRAIN_BATCH} x {size} x {size} x 3 f32, flip and "
        f"shift {P10_SHIFT}): ms {[round(t * 1e3, 3) for t in aug_times]} median "
        f"{np.median(aug_times) * 1e3:.3f}")
    # Accumulation against plain, in f32 with TF32 off (in bf16 the LSTM's
    # weight gradients are summed over the 34 steps in bf16, a few 1e-2 of
    # their scale apart whatever the split): each step under plain SGD at a
    # large lr, so that (params - updated) / lr gives back the gradient it
    # applied; sums in another order, within 1e-4 of each tensor's scale.
    apply_precision("f32")
    sgd = chain(scale_by_learning_rate(P10_SGD_LR))
    grads, losses = {}, {}
    for a in (1, 2):
        step = make_joint_train_step(pipe.encoder, pipe.decoder, sgd, deterministic=True, grad_accum_steps=a)
        new, m = step(TrainState.create(params, sgd, None), images, tokens)
        grads[a] = [((p - q) / P10_SGD_LR).cpu() for p, q in zip(tree_leaves(params), tree_leaves(new.params))]
        losses[a] = float(m["loss"])
        del new
    worst, where = 0.0, None
    for i, (a, b) in enumerate(zip(grads[2], grads[1])):
        scale = float(b.abs().max())
        share = max_err(a, b) / scale if scale else 0.0
        if share > worst:
            worst, where = share, i
    rel = abs(losses[2] - losses[1]) / abs(losses[1])
    if worst > 1e-4 or rel > 1e-5:
        raise AssertionError(f"finetune dials accum 2, f32: a gradient (leaf {where}) differs from plain's by "
                             f"{worst:.3g} of its scale, the loss by {rel:.3g}")
    log(f"finetune dials: accum 2 against plain in f32 (TF32 off): loss relative {rel:.3g} (tol 1e-5); "
        f"gradients' worst share of a tensor's scale {worst:.3g} over {len(grads[1])} tensors (tol 1e-4)")
    apply_precision(pipe.config.precision)
    return total


def run_finetune_cli(dev) -> dict[str, int]:
    """10(b): ``train --finetune-encoder`` on phase 8's dataset (its training
    split cut to FT_CLI_TRAIN_IDS ids) with remat, accumulation over 2,
    augmentation, a checkpoint every FT_CLI_EVERY steps and the SIGTERM
    guard, three times in this process: uninterrupted; cut by SIGTERM once
    the first step-interval checkpoint appears; resumed. The resumed
    bundle against the uninterrupted one, then that bundle's greedy
    captions of the test split (K2, K3). -> the caption's launches."""
    import shutil
    import signal
    import tempfile
    import threading

    from tpucap_torch import ops
    from tpucap_torch.checkpoint import CheckpointManager
    from tpucap_torch.convert import load_npz
    from tpucap_torch.core import tree_leaves
    from tpucap_torch.pipeline import PARAMS_FILE, CaptioningPipeline

    io_s: dict[str, list] = {"save": [], "restore": []}
    real = {k: getattr(CheckpointManager, k) for k in io_s}

    def timed_io(kind):
        def call(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = real[kind](self, *a, **kw)
            io_s[kind].append((t0, time.perf_counter()))
            return r

        return call

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ids = write_cli_dataset(root)
        (root / "ft_train.txt").write_text("".join(f"{k}.jpg\n" for k in ids[:FT_CLI_TRAIN_IDS]))
        steps_per_epoch = FT_CLI_TRAIN_IDS * CLI_REFS // CLI_TRAIN_BATCH

        def argv(ckpt, *extra):
            return ["train", "--finetune-encoder", *CLI_MODEL, "--tokens", root / "tokens.txt", "--split",
                    root / "ft_train.txt", "--images", root / "images", "--augment", "--augment-shift",
                    FT_CLI_SHIFT, "--remat-encoder", "--grad-accum-steps", 2, "--checkpoint-every-steps",
                    FT_CLI_EVERY, "--handle-preemption", "--epochs", FT_CLI_EPOCHS, "--batch-size",
                    CLI_TRAIN_BATCH, "--checkpoint-dir", ckpt, *extra]

        def report(label, out, wall, t0, peak):
            epochs = [(t, line) for t, line in out if line.startswith("epoch ")]
            spans, last = [], t0
            for t, _ in epochs:
                saves = sum(b - a for a, b in io_s["save"] if last <= a and b <= t)
                spans.append((t - last, saves))
                last = t
            step_ms = [(span - saves) / steps_per_epoch * 1e3 for span, saves in spans[1:]]
            log(f"cli finetune {label}: wall {wall:.5f} s; epoch lines' spans (s, saves within) "
                f"{[(round(a, 5), round(b, 5)) for a, b in spans]} (the first from the command's start: "
                f"VGG16's random build and the image reads included); step ms from the later epochs "
                f"{[round(x, 3) for x in step_ms]}; peak memory {peak / 2**30:.3f} GiB; saves s "
                f"{[round(b - a, 5) for a, b in io_s['save']]}; restores s "
                f"{[round(b - a, 5) for a, b in io_s['restore']]}")
            for _, line in out:
                log(f"cli finetune {label}: {line!r}")

        def run(label, args):
            for v in io_s.values():
                v.clear()
            torch.cuda.reset_peak_memory_stats()
            out, err, wall, t0 = run_cli(args)
            report(label, out, wall, t0, torch.cuda.max_memory_allocated())
            return [line for _, line in out]

        for k in io_s:
            setattr(CheckpointManager, k, timed_io(k))
        late: list = []
        previous = signal.signal(signal.SIGTERM, lambda *_: late.append(time.perf_counter()))
        try:
            with deterministic_torch("cli finetune"):
                a, b = root / "uncut", root / "cut"
                uncut = run("uncut", argv(a))
                # Only the bundle is compared: the steps' 1.7 GB each go.
                for d in a.iterdir():
                    if d.name.isdigit():
                        shutil.rmtree(d)

                def watch():
                    while not (b / str(FT_CLI_EVERY)).is_dir():
                        if done.is_set():
                            return
                        time.sleep(0.002)
                    sent.append(time.perf_counter())
                    os.kill(os.getpid(), signal.SIGTERM)

                done, sent = threading.Event(), []
                watcher = threading.Thread(target=watch, daemon=True)
                watcher.start()
                try:
                    cut = run("cut", argv(b))
                finally:
                    done.set()
                    watcher.join()
                held = CheckpointManager(b, best_metric="val_loss")
                held = [(s, held.metrics(s)) for s in held.all_steps()]
                resumed = run("resume", argv(b, "--resume"))
        finally:
            signal.signal(signal.SIGTERM, previous)
            for k, fn in real.items():
                setattr(CheckpointManager, k, fn)
        want_last = f"finetuned {FT_CLI_EPOCHS} epochs; final loss "
        if not uncut[-1].startswith(want_last) or not uncut[-1].endswith(f"bundle in {a / 'bundle'}"):
            raise AssertionError(f"cli finetune uncut: printed {uncut}")
        rescue = next((line for line in cut if line.startswith("preempted at epoch ")), "")
        if not sent or late or not rescue or not cut[-1].startswith("preempted after "):
            raise AssertionError(f"cli finetune cut: SIGTERM sent {sent}, after the guard {late}; printed {cut}")
        step = int(rescue.split(" step ")[1].split(";")[0])
        if held[-1] != (step, None) or step < FT_CLI_EVERY:
            raise AssertionError(f"cli finetune cut: rescue at {step}, the manager held {held}")
        epoch, batch = divmod(step, steps_per_epoch)
        if resumed[0] != f"resumed from step {step} (epoch {epoch}, batch {batch})" or not resumed[-1].startswith(
            f"finetuned {FT_CLI_EPOCHS - epoch} epochs; final loss "
        ) or (epoch == 0 and resumed[-1].split(";")[1] != uncut[-1].split(";")[1]):
            raise AssertionError(f"cli finetune resume: printed {resumed}; uncut {uncut[-1]}")
        got, want = (load_npz(d / "bundle" / PARAMS_FILE) for d in (b, a))
        gl, wl = tree_leaves(got), tree_leaves(want)
        worst = max(max_err(x, y) for x, y in zip(gl, wl))
        if len(gl) != len(wl) or not all(torch.equal(x, y) for x, y in zip(gl, wl)):
            raise AssertionError(f"cli finetune: the resumed bundle differs from the uninterrupted one by "
                                 f"up to {worst}")
        log(f"cli finetune: SIGTERM after step {FT_CLI_EVERY}'s checkpoint, the rescue at step {step} "
            f"(epoch {epoch}, batch {batch}), resumed: the bundle's {len(gl)} params equal the "
            f"uninterrupted run's bit for bit")

        # The fine-tuned bundle serves: its encoder's features, K2 and K3's
        # f32 routes at the test split's rows.
        pipe = CaptioningPipeline.load(b / "bundle")
        paths = [root / "images" / f"{k}.jpg" for k in ids[-CLI_SPLITS[2]:]]
        feats = pipe.extract_features(paths, batch_size=CLI_TRAIN_BATCH)
        ops.reset_launch_counts()
        caps, caption_s = timed(lambda: pipe.caption_images(paths))
        counts = ops.launch_counts()
        steps_c = check_cli_counts("cli finetune caption", counts, 1)
        if len(caps) != len(paths) or not all(isinstance(c, str) for c in caps):
            raise AssertionError(f"cli finetune caption: {caps[:4]}")
        words = sorted({len(c.split()) for c in caps})
        check_monitor_route(pipe, feats, "cli finetune bundle route")
        log(f"cli finetune: CaptioningPipeline.load(bundle).caption_images of {len(paths)} test images, "
            f"{pipe.config.decode.method}: {caption_s:.5f} s; launches K2 {steps_c}, K3 "
            f"{counts['merge_head']} + {counts['vocab_proj']}; caption lengths {words} words "
            f"(a random VGG16 after {FT_CLI_EPOCHS} short epochs), e.g. {max(caps, key=len)!r}")
        return counts


# -- phase 11: EMA, checkpoint averaging and the optimizer surface -----------

# (a) fit with EMA: the production recipe's decay, epochs and microbatches;
# (b) each optimizer's steps, the warmup before the cosine and the
# exponential decay's interval and rate; (c) the joint fit's steps and
# warmup; (d) the CLI's epochs and warmup.
P11_DECAY, P11_EPOCHS, P11_ACCUM = 0.999, 2, 2
P11_STEPS, P11_WARMUP, P11_DECAY_STEPS, P11_DECAY_RATE, P11_LR = 12, 10, 4, 0.5, 0.01
P11_FT_STEPS, P11_FT_WARMUP = 4, 1
P11_CLI_EPOCHS, P11_CLI_WARMUP = 2, 10


def check_launches(label: str, counts: dict[str, int], fixed: dict[str, int], decode: bool) -> int:
    """The kernels in ``fixed`` launched that many times; with ``decode``,
    K2 and K3's two kernels the same count, one a step, 1 to MAX_LEN steps;
    no other kernel. -> the decode steps."""
    steps = counts["lstm_cell"] if decode else 0
    expect = {name: 0 for name in counts}
    expect.update(fixed)
    if decode:
        expect.update(lstm_cell=steps, merge_head=steps, vocab_proj=steps)
    if counts != expect or (decode and not 1 <= steps <= MAX_LEN):
        raise AssertionError(f"{label}: launch counts {counts}, expected {expect}")
    return steps


def same_tree(a, b) -> bool:
    """The same containers (a tuple is not a list) and every leaf equal
    with its dtype."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return a is None or (a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()))


def ema_fit(dev, tokenizer) -> dict[str, int]:
    """11(a): ``fit`` at batch DEC_TRAIN_BATCH, bf16 compute, FIT_TRAIN
    rows of 2048-d features, P11_EPOCHS epochs, grad_accum_steps
    P11_ACCUM, val_metric cider on FIT_VAL rows, a CheckpointManager:
    without EMA, with ``ema_decay`` P11_DECAY, and with it again while each
    step's params are copied to the host. The params equal without and with
    EMA; the shadow equals the host's f32 recurrence from those copies bit
    for bit (the CPU test's hand value); the EMA's device ms a step and the
    peak memory with and without. Then ``use_ema_weights`` and a greedy
    ``generate`` of one batch (K2, K3 once a step), and
    ``use_averaged_weights(last_k=2)`` against the numpy mean of the two
    restored checkpoints. -> the EMA run's and the decode's launches."""
    import tempfile

    from tpucap_torch import ops
    from tpucap_torch import pipeline as tpipe
    from tpucap_torch.checkpoint import CheckpointManager
    from tpucap_torch.config import TrainConfig
    from tpucap_torch.core import tree_leaves, tree_map
    from tpucap_torch.train import TrainState, build_optimizer

    train = training_corpus(tokenizer, FIT_TRAIN, 30)
    val = training_corpus(tokenizer, FIT_VAL, 31, prefix="val")
    feats = random_features([*train, *val], 32)
    steps = P11_EPOCHS * (FIT_TRAIN // DEC_TRAIN_BATCH)
    real_update = tpipe.ema_update
    copies: list = []

    def recording(shadow, params, decay):
        copies.append([t.detach().cpu().clone() for t in tree_leaves(params)])
        real_update(shadow, params, decay)

    runs = {}
    with tempfile.TemporaryDirectory() as tmp, deterministic_torch("ema fit"):
        for label, decay in (("plain", 0.0), ("ema", P11_DECAY), ("recorded", P11_DECAY)):
            pipe = make_pipeline("bf16", tokenizer)
            pipe.config = dataclasses.replace(pipe.config, train=TrainConfig(
                batch_size=DEC_TRAIN_BATCH, precision="bf16", grad_accum_steps=P11_ACCUM, ema_decay=decay,
                val_metric="cider"))
            p0 = [t.detach().cpu().clone() for t in tree_leaves(pipe.params["decoder"])]
            ckpt = Path(tmp) / label
            tpipe.ema_update = recording if label == "recorded" else real_update
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            try:
                hist, wall = timed(lambda: pipe.fit(train, feats, epochs=P11_EPOCHS, val_data=(val, feats),
                                                    checkpoint_manager=CheckpointManager(ckpt), log=None))
            finally:
                tpipe.ema_update = real_update
            # The peak above what was held before the fit (the earlier runs' pipelines stay).
            runs[label] = dict(pipe=pipe, hist=hist, wall=wall, peak=torch.cuda.max_memory_allocated() - held,
                               counts=ops.launch_counts(), p0=p0, ckpt=ckpt)
        plain, ema, rec = runs["plain"], runs["ema"], runs["recorded"]
        for r in runs.values():
            if len(r["hist"]) != P11_EPOCHS or not all(
                np.isfinite(e[k]) for e in r["hist"] for k in ("loss", "val_loss", "val_cider")
            ):
                raise AssertionError(f"ema fit: history {r['hist']}")
        trained = [r["pipe"].params["decoder"] for r in (plain, ema)]
        if plain["hist"] != ema["hist"] or not same_tree(*trained):
            raise AssertionError("ema fit: the params or the history differ with EMA on")
        if plain["pipe"].ema_params is not None or sorted(ema["pipe"].ema_params) != ["decoder"]:
            raise AssertionError("ema fit: ema_params is not {'decoder'} after fit with EMA only")
        if not same_tree(ema["pipe"].ema_params, rec["pipe"].ema_params):
            raise AssertionError("ema fit: the shadow differs when the steps' params are copied out")
        if len(copies) != steps:
            raise AssertionError(f"ema fit: {len(copies)} EMA updates for {steps} steps")
        host = [t.clone() for t in rec["p0"]]
        for p in copies:
            for e, x in zip(host, p):
                e.mul_(P11_DECAY).add_(x * (1 - P11_DECAY))
        shadow = tree_leaves(rec["pipe"].ema_params["decoder"])
        if not all(torch.equal(e, s.cpu()) for e, s in zip(host, shadow)):
            worst = max(max_err(e, s.cpu()) for e, s in zip(host, shadow))
            raise AssertionError(f"ema fit: the shadow differs from the host's f32 recurrence by {worst}")
        del copies[:]
        pipe = ema["pipe"]
        params = pipe.params["decoder"]
        work = tree_map(torch.clone, pipe.ema_params["decoder"])
        ema_ms = cuda_ms(lambda: real_update(work, params, P11_DECAY))
        n_params = sum(t.numel() for t in tree_leaves(params))
        k2 = check_cli_counts("ema fit monitor", ema["counts"], P11_EPOCHS * -(-FIT_VAL // DEC_TRAIN_BATCH))
        log(f"ema fit: lstm1 batch {DEC_TRAIN_BATCH} bf16 compute, accumulation {P11_ACCUM}, {FIT_TRAIN} rows, "
            f"{P11_EPOCHS} epochs ({steps} steps), val_metric cider on {FIT_VAL} rows, checkpoints: the params "
            f"and history equal without EMA bit for bit; the shadow of {n_params} params equals the host's f32 "
            f"recurrence over the {steps} steps' params bit for bit; the EMA update {ema_ms:.5f} ms a step "
            f"(CUDA graph, three multi-tensor ops); fit wall {plain['wall']:.5f} s without, {ema['wall']:.5f} s "
            f"with ({(ema['wall'] - plain['wall']) / steps * 1e3:.3f} ms a step more, monitor decode and saves "
            f"included); the fit's peak memory above what was held before it {plain['peak'] / 2**30:.4f} GiB "
            f"without, {ema['peak'] / 2**30:.4f} GiB with (+{(ema['peak'] - plain['peak']) / 2**20:.2f} MiB; the "
            f"shadow is {n_params * 4 / 2**20:.2f} MiB); "
            f"the monitor's greedy decode launched K2 {k2}, K3 {ema['counts']['merge_head']} + "
            f"{ema['counts']['vocab_proj']}")

        replaced = pipe.use_ema_weights()
        if replaced["decoder"] is not params or pipe.params["decoder"] is not pipe.ema_params["decoder"]:
            raise AssertionError("ema fit: use_ema_weights did not swap the shadow in")
        x = np.stack([feats[k] for k in list(val)[:DEC_TRAIN_BATCH]])
        ops.reset_launch_counts()
        caps, decode_s = timed(lambda: pipe.generate(x, method="greedy"))
        decode_counts = ops.launch_counts()
        steps_d = check_cli_counts("ema generate", decode_counts, 1)
        if len(caps) != DEC_TRAIN_BATCH or not all(isinstance(c, str) for c in caps):
            raise AssertionError(f"ema generate: {caps[:4]}")
        log(f"ema generate: use_ema_weights, then greedy generate of {DEC_TRAIN_BATCH} rows, bf16: "
            f"{decode_s:.5f} s; K2 {steps_d}, K3 {decode_counts['merge_head']} + {decode_counts['vocab_proj']} "
            f"({steps_d} steps)")

        mgr = CheckpointManager(ema["ckpt"], best_metric=None)
        kept = mgr.all_steps()
        template = TrainState.create(pipe.params["decoder"], build_optimizer(pipe.config.train), None)
        pair = [tree_leaves(mgr.restore(template, s).params) for s in kept[-2:]]
        pipe.use_averaged_weights(ema["ckpt"], last_k=2)
        got = tree_leaves(pipe.params["decoder"])
        worst = 0.0
        for g, a, b in zip(got, *pair):
            want = (a.double().cpu().numpy() + b.double().cpu().numpy()) / 2
            err = float(np.abs(g.double().cpu().numpy() - want).max())
            worst = max(worst, err / max(float(np.abs(want).max()), 1e-30))
        if len(kept) < 2 or worst > 1e-6:
            raise AssertionError(f"ema fit: use_averaged_weights of steps {kept[-2:]} is {worst} of scale "
                                 "from their numpy mean")
        log(f"ema fit: use_averaged_weights(last_k=2) of steps {kept[-2:]}: within {worst:.3g} of each "
            f"tensor's scale of the numpy mean of the two restored checkpoints (bound 1e-6)")
    return {k: ema["counts"][k] + decode_counts[k] for k in decode_counts}


def optimizer_steps(dev) -> None:
    """11(b): ``make_train_step`` at phase 5(a)'s shapes (lstm1, batch
    DEC_TRAIN_BATCH, vocab VOCAB, bf16 compute, f32 masters) under each
    optimizer of ``build_optimizer``, P11_STEPS steps from one init. Plain
    sgd under constant, cosine with P11_WARMUP warmup steps and exponential
    decay: each step's update is -lr(step) * g, where lr(step) is the
    schedule on the card, within one ulp of the base lr of the same
    schedule evaluated on the host in f32. Then sgd with momentum 0.9
    under cosine with warmup, rmsprop with exponential decay, adagrad and
    adamw with cosine: finite losses, step ms, and the state saved and
    restored through the CheckpointManager bit for bit, containers
    included."""
    import tempfile

    from tpucap_torch.checkpoint import CheckpointManager
    from tpucap_torch.config import TrainConfig
    from tpucap_torch.core import tree_leaves, tree_map
    from tpucap_torch.models.decoders import build_decoder
    from tpucap_torch.train import TrainState, build_optimizer, make_train_step
    from tpucap_torch.train.loop import GradientTransformation, lr_schedule

    dec = build_decoder("lstm1", VOCAB, DEC_FEATURES, embed_dim=WIDTH, hidden_dim=WIDTH)
    params0 = tree_to(dec.init(torch.Generator().manual_seed(0)), dev)
    g = torch.Generator(device=dev).manual_seed(33)
    feats = torch.randn((DEC_TRAIN_BATCH, DEC_FEATURES), generator=g, device=dev)
    tokens = torch.randint(1, VOCAB, (DEC_TRAIN_BATCH, MAX_LEN + 1), generator=g, device=dev)
    decay = dict(lr_decay_steps=P11_DECAY_STEPS, lr_decay_rate=P11_DECAY_RATE)

    def run(fields, seen=None):
        cfg = TrainConfig(learning_rate=P11_LR, **fields)
        opt = build_optimizer(cfg, total_steps=P11_STEPS)
        if seen is not None:
            inner = opt

            def update(grads, state, params=None):
                u, s = inner.update(grads, state, params)
                seen.append((len(seen), grads, u))
                return u, s

            opt = GradientTransformation(inner.init, update, inner.stateless)
        state = TrainState.create(tree_map(torch.clone, params0), opt, torch.Generator(device=dev).manual_seed(0))
        step = make_train_step(dec, opt, compute_dtype=torch.bfloat16, donate=True)
        losses, times = [], []
        for _ in range(P11_STEPS):
            (state, m), s = timed(lambda: step(state, feats, tokens))
            losses.append(float(m["loss"]))
            times.append(s)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"optimizer {fields}: losses {losses}")
        return cfg, opt, state, losses, times

    for name, fields in (("constant", {}), ("cosine", dict(lr_schedule="cosine", warmup_steps=P11_WARMUP)),
                         ("exponential", dict(lr_schedule="exponential", **decay))):
        seen: list = []
        cfg, _, _, _, times = run(dict(optimizer="sgd", **fields), seen)
        sched = lr_schedule(cfg, total_steps=P11_STEPS)
        ulp = float(np.spacing(np.float32(P11_LR)))
        worst, lrs = 0.0, []
        for k, grads, u in seen:
            count = torch.tensor(k, dtype=torch.int32)
            host = np.float32(P11_LR if sched is None else sched(count).item())
            if sched is None:
                want = tree_map(lambda x: -P11_LR * x, grads)
                card = host
            else:
                lr = sched(torch.tensor(k, dtype=torch.int32, device=dev))
                want = tree_map(lambda x: (-lr).to(x.dtype) * x, grads)
                card = np.float32(lr.item())
            worst = max(worst, abs(float(card) - float(host)) / ulp)
            lrs.append(float(card))
            if not all(torch.equal(a, b) for a, b in zip(tree_leaves(u), tree_leaves(want))) or worst > 1:
                raise AssertionError(f"sgd {name} step {k}: the update is not -lr(step) g, or lr {card} is "
                                     f"{worst} ulp of the base lr from the host's {host}")
        log(f"sgd {name}: {P11_STEPS} steps, every update -lr(step) g bit for bit, lr(step) on the card within "
            f"{worst:g} ulp of the base lr {P11_LR} of the host's f32 schedule; lr {[f'{x:.6g}' for x in lrs]}; "
            f"step ms median {float(np.median(times)) * 1e3:.3f}")

    with tempfile.TemporaryDirectory() as tmp:
        for name, fields in (
            ("sgd", dict(optimizer="sgd")),
            ("sgd momentum cosine warmup", dict(optimizer="sgd", momentum=0.9, lr_schedule="cosine",
                                                warmup_steps=P11_WARMUP)),
            ("rmsprop exponential", dict(optimizer="rmsprop", lr_schedule="exponential", **decay)),
            ("adagrad", dict(optimizer="adagrad")),
            ("adamw cosine", dict(optimizer="adamw", weight_decay=0.01, lr_schedule="cosine")),
        ):
            _, opt, state, losses, times = run(fields)
            mgr = CheckpointManager(Path(tmp) / name.replace(" ", "_"), best_metric=None)
            save_s = timed(lambda: mgr.save(state))[1]
            template = TrainState.create(tree_map(torch.zeros_like, params0), opt, torch.Generator(device=dev))
            back, restore_s = timed(lambda: mgr.restore(template))
            if not same_tree(back.opt_state, state.opt_state) or not same_tree(back.params, state.params):
                raise AssertionError(f"{name}: the checkpoint's optimizer state or params differ restored")
            layout = type(state.opt_state).__name__
            log(f"{name}: {P11_STEPS} steps, losses {losses[0]:.6f} -> {losses[-1]:.6f}, step ms median "
                f"{float(np.median(times)) * 1e3:.3f}; opt_state a {layout} of "
                f"{len(tree_leaves(state.opt_state))} tensors, saved {save_s:.4f} s and restored {restore_s:.4f} s "
                f"bit for bit")


def ema_finetune(dev, tokenizer) -> dict[str, int]:
    """11(c): ``fit_finetune`` (ViT-B/16 flash + lstm1, batch TRAIN_BATCH,
    bf16) with adamw under cosine with P11_FT_WARMUP warmup steps,
    P11_FT_STEPS steps, without and with ``ema_decay`` P11_DECAY: 12
    launches each of K5, dK/dV and dQ a step, the shadow of both trees,
    the peak memory of each. Then ``use_ema_weights`` and ``caption_batch``
    of TRAIN_BATCH uint8 images (K1 once, K5 12 times, K2 and K3 once a
    step). -> the EMA run's and the caption's launches."""
    from tpucap_torch import ops
    from tpucap_torch.config import TrainConfig
    from tpucap_torch.core import tree_leaves

    desc = training_corpus(tokenizer, TRAIN_BATCH, 40)
    rng = np.random.default_rng(41)
    images = {k: rng.uniform(-1, 1, size=(IMAGE, IMAGE, 3)).astype(np.float32) for k in desc}
    runs = {}
    for decay in (0.0, P11_DECAY):
        pipe = finetune_pipeline(tokenizer, "bf16")
        pipe.config = dataclasses.replace(pipe.config, train=TrainConfig(
            batch_size=TRAIN_BATCH, precision="bf16", optimizer="adamw", weight_decay=1e-4,
            lr_schedule="cosine", warmup_steps=P11_FT_WARMUP, ema_decay=decay))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        hist, s = timed(lambda: pipe.fit_finetune(desc, images, epochs=P11_FT_STEPS, log=None))
        counts = ops.launch_counts()
        layers = pipe.encoder.num_layers
        check_launches(f"ema finetune {decay}", counts, {k: layers * P11_FT_STEPS for k in (
            "flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")}, decode=False)
        losses = [h["loss"] for h in hist]
        if len(hist) != P11_FT_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"ema finetune {decay}: losses {losses}")
        peak = torch.cuda.max_memory_allocated()
        runs[decay] = dict(pipe=pipe, s=s, peak=peak, above=peak - held, counts=counts, losses=losses)
    plain, ema = runs[0.0], runs[P11_DECAY]
    pipe = ema["pipe"]
    if plain["losses"] != ema["losses"] or sorted(pipe.ema_params) != ["decoder", "encoder"]:
        raise AssertionError(f"ema finetune: losses {plain['losses']} / {ema['losses']}, "
                             f"ema_params {sorted(pipe.ema_params)}")
    n_params = sum(t.numel() for t in tree_leaves(pipe.ema_params))
    log(f"ema finetune: vit_b16 flash + lstm1, batch {TRAIN_BATCH}, bf16, adamw cosine warmup {P11_FT_WARMUP}, "
        f"{P11_FT_STEPS} steps: launches a step {layers} each of K5, dK/dV, dQ; losses equal without and with EMA "
        f"{[round(x, 4) for x in ema['losses']]}; ema_params holds encoder and decoder ({n_params} params, "
        f"{n_params * 4 / 2**30:.4f} GiB f32); peak memory {plain['peak'] / 2**30:.4f} GiB without, "
        f"{ema['peak'] / 2**30:.4f} GiB with, above what was held before the run {plain['above'] / 2**30:.4f} "
        f"and {ema['above'] / 2**30:.4f} GiB (the first run's pipeline stays for the second); wall "
        f"{plain['s']:.4f} s without, {ema['s']:.4f} s with")
    pipe.use_ema_weights()
    u8 = np.random.default_rng(42).integers(0, 256, size=(TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)
    ops.reset_launch_counts()
    caps, caption_s = timed(lambda: pipe.caption_batch(u8))
    counts = ops.launch_counts()
    check_launches("ema finetune caption_batch", counts,
                   {"preprocess_u8": 1, "flash_attention": pipe.encoder.num_layers}, decode=True)
    if len(caps) != TRAIN_BATCH:
        raise AssertionError(f"ema finetune caption_batch: {len(caps)} captions")
    log(f"ema finetune: use_ema_weights, then caption_batch of {TRAIN_BATCH} uint8 images: {caption_s:.5f} s; "
        f"launches {counts}")
    return {k: ema["counts"][k] + counts[k] for k in counts}


def ema_cli(dev) -> dict[str, int]:
    """11(d): the CLI on phase 8's dataset: ``extract``, then ``train
    --ema-decay P11_DECAY --optimizer sgd --momentum 0.9 --lr-schedule
    cosine --warmup-steps P11_CLI_WARMUP`` (P11_CLI_EPOCHS epochs), which
    writes ``bundle_ema``; ``CaptioningPipeline.load`` of it captions
    CLI_CAPTIONED images (K2 and K3 once a step); ``evaluate --average-last
    2`` with the same optimizer flags gives the scores of
    ``use_averaged_weights`` and ``evaluate`` on the same checkpoints. ->
    the caption's and evaluate's launches."""
    import tempfile

    from tpucap_torch import ops
    from tpucap_torch.cli.main import _build_config, build_parser
    from tpucap_torch.data import load_descriptions, load_split, prepare_descriptions
    from tpucap_torch.pipeline import CaptioningPipeline
    from tpucap_torch.text import load_tokenizer

    flags = ["--optimizer", "sgd", "--momentum", "0.9", "--lr-schedule", "cosine", "--warmup-steps",
             P11_CLI_WARMUP]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ids = write_cli_dataset(root)
        feats_path, ckpt = root / "features.npz", root / "ckpt"
        run_cli(["extract", *CLI_MODEL, "--images", root / "images", "--out", feats_path, "--batch-size",
                 CLI_EXTRACT_BATCH])
        out, _, train_s, _ = run_cli([
            "train", *CLI_MODEL, "--tokens", root / "tokens.txt", "--split", root / "train.txt", "--features",
            feats_path, "--checkpoint-dir", ckpt, "--epochs", P11_CLI_EPOCHS, "--batch-size", CLI_TRAIN_BATCH,
            "--ema-decay", P11_DECAY, *flags])
        lines = [line for _, line in out]
        if lines[-2:-1] != [f"EMA weights (decay {P11_DECAY}) bundled in {ckpt / 'bundle_ema'}"] or not \
                lines[-1].startswith(f"trained {P11_CLI_EPOCHS} epochs; final loss "):
            raise AssertionError(f"cli ema train: printed {lines}")
        bundle, load_s = timed(lambda: CaptioningPipeline.load(ckpt / "bundle_ema"))
        t = bundle.config.train
        if (t.ema_decay, t.optimizer, t.momentum, t.lr_schedule, t.warmup_steps) != (
                P11_DECAY, "sgd", 0.9, "cosine", P11_CLI_WARMUP):
            raise AssertionError(f"cli ema train: the bundle's train config {t}")
        picked = [root / "images" / f"{k}.jpg" for k in ids[:CLI_CAPTIONED]]
        ops.reset_launch_counts()
        caps, caption_s = timed(lambda: bundle.caption_images(picked))
        cap_counts = ops.launch_counts()
        steps_c = check_cli_counts("cli ema caption", cap_counts, 1)
        if len(caps) != CLI_CAPTIONED:
            raise AssertionError(f"cli ema caption: {caps}")
        del bundle
        evaluate = ["evaluate", *CLI_MODEL, "--tokens", root / "tokens.txt", "--split", root / "test.txt",
                    "--features", feats_path, "--checkpoint-dir", ckpt, "--average-last", 2, "--batch-size",
                    CLI_TRAIN_BATCH, "--metrics", "bleu,cider", *flags]
        ops.reset_launch_counts()
        out, _, eval_s, _ = run_cli(evaluate)
        ev_counts = ops.launch_counts()
        steps_e = check_cli_counts("cli ema evaluate", ev_counts, 1)
        scores = json.loads(out[-1][1])
        cfg = _build_config(build_parser()[0].parse_args([str(a) for a in evaluate]))
        ref = CaptioningPipeline(cfg, tokenizer=load_tokenizer(ckpt / "tokenizer.json"), device=dev)
        ref.build()
        ref.use_averaged_weights(ckpt, last_k=2)
        with np.load(feats_path) as z:
            feats = {k: z[k] for k in z.files}
        test = prepare_descriptions(load_descriptions(root / "tokens.txt"), load_split(root / "test.txt"))
        want = ref.evaluate(test, feats, batch_size=CLI_TRAIN_BATCH, metrics=("bleu", "cider"))
        if scores != want or not all(np.isfinite(v) for v in scores.values() if v is not None):
            raise AssertionError(f"cli ema evaluate: scores {scores}, use_averaged_weights + evaluate {want}")
        log(f"cli ema: {' '.join(CLI_MODEL)} train {' '.join(map(str, flags))} --ema-decay {P11_DECAY}, "
            f"{P11_CLI_EPOCHS} epochs: {train_s:.5f} s (extract's features; bundle_ema written); "
            f"CaptioningPipeline.load(bundle_ema) {load_s:.5f} s, its caption_images of {CLI_CAPTIONED} images "
            f"{caption_s:.5f} s, "
            f"K2 {steps_c}, K3 {cap_counts['merge_head']} + {cap_counts['vocab_proj']}; evaluate --average-last 2 "
            f"with the same flags {eval_s:.5f} s, the scores of use_averaged_weights + evaluate, K2 {steps_e}; "
            f"e.g. {caps[0]!r}")
        log(f"cli ema evaluate: scores { {k: (round(v, 6) if v is not None else None) for k, v in scores.items()} }")
    return {k: cap_counts[k] + ev_counts[k] for k in cap_counts}


# -- phase 12: scheduled sampling, steps_per_dispatch, frozen embeddings, score, compare --

# (a) the scheduled-sampling fit's rows, dev rows, epochs and largest eps;
# (b) the dispatch runs' steps an epoch, epochs, checkpoint interval and
# group sizes; (c) the frozen fits' rows and epochs, the joint fit's steps,
# the words of the GloVe file outside the vocabulary; (d) the rows scored;
# (e) the CLI's epochs, group size and images scored.
P12_FIT_ROWS, P12_VAL_ROWS, P12_EPOCHS, P12_SS = 1024, 256, 3, 0.5
P12_SPD_STEPS, P12_SPD_EPOCHS, P12_EVERY, P12_SPDS = 10, 2, 5, (1, 4, 8)
P12_FROZEN_EPOCHS, P12_FT_STEPS, P12_OOV = 2, 2, 5
P12_SCORE_ROWS = 256
P12_CLI_EPOCHS, P12_CLI_SPD, P12_SCORED = 2, 4, 8


def decoder_pipeline(tokenizer, train, precision: str = "f32"):
    """A pipeline of phase 5(a)'s decoder (lstm1 at WIDTH, 2048-d features,
    max_len MAX_LEN) with ``train`` (a TrainConfig) and no encoder params:
    the phase trains and decodes on feature rows."""
    from tpucap_torch.config import Config, DecodeConfig, DecoderConfig, EncoderConfig
    from tpucap_torch.pipeline import CaptioningPipeline

    cfg = Config(encoder=EncoderConfig("resnet50", "pooled", DEC_FEATURES),
                 decoder=DecoderConfig(name="lstm1", embed_dim=WIDTH, hidden_dim=WIDTH),
                 decode=DecodeConfig(max_len=MAX_LEN), train=train, precision=precision)
    pipe = CaptioningPipeline(cfg, tokenizer=tokenizer)
    pipe.build(init_params=False)
    pipe.set_params({"encoder": {}, "decoder": pipe.decoder.init(torch.Generator().manual_seed(0))})
    return pipe


def scheduled_step(dev, tokenizer) -> None:
    """12(a), the step: ``make_train_step`` at phase 5(a)'s shapes, bf16
    compute, dropout off, torch's deterministic settings on: eps 0 gives the
    plain step's update bit for bit; at eps 1 the mixed inputs equal a host
    recomputation from pass 1's argmax and the mixing rules; how many pass-1
    tokens bf16 compute changes against f32 (TF32 off); step ms with
    scheduled sampling off and on (eps 0.5), median of 5."""
    from tpucap_torch.config import TrainConfig
    from tpucap_torch.core import precision_flags, tree_map
    from tpucap_torch.train import TrainState, build_optimizer, build_training_tokens, make_train_step
    from tpucap_torch.train import loss as tloss
    from tpucap_torch.train.loss import cast_floats

    pipe = decoder_pipeline(tokenizer, TrainConfig())
    dec, params0 = pipe.decoder, tree_to(pipe.params["decoder"], dev)
    g = torch.Generator(device=dev).manual_seed(50)
    feats = torch.randn((DEC_TRAIN_BATCH, DEC_FEATURES), generator=g, device=dev)
    _, tokens = build_training_tokens(tokenizer, training_corpus(tokenizer, DEC_TRAIN_BATCH, 51), MAX_LEN)
    tokens = torch.from_numpy(tokens).to(dev).long()
    opt = build_optimizer(TrainConfig())

    def fresh():
        return TrainState.create(tree_map(torch.clone, params0), opt, torch.Generator(device=dev).manual_seed(52))

    kw = dict(deterministic=True, compute_dtype=torch.bfloat16)
    plain = make_train_step(dec, opt, **kw)
    ss = make_train_step(dec, opt, scheduled_sampling=True, **kw)
    with deterministic_torch("ss step"):
        a, ma = plain(fresh(), feats, tokens)
        b, mb = ss(fresh(), feats, tokens, 0.0)
        if not (same_tree(a.params, b.params) and same_tree(a.opt_state, b.opt_state)) or float(ma["loss"]) != float(
                mb["loss"]):
            raise AssertionError("ss step: eps 0 is not the plain step's update bit for bit")
        recorded = []
        real = tloss.scheduled_inputs

        def recording(*args, **kwargs):
            out = real(*args, **kwargs)
            recorded.append((out, kwargs["coin"]))
            return out

        tloss.scheduled_inputs = recording
        try:
            _, m1 = ss(fresh(), feats, tokens, 1.0)
        finally:
            tloss.scheduled_inputs = real
        mixed, coin = (t.cpu().numpy() for t in recorded[0])
        inputs = tokens[:, :-1]
        with torch.no_grad():
            preds = {
                "bf16": dec.forward_train(cast_floats(params0, torch.bfloat16), feats.to(torch.bfloat16), inputs,
                                          deterministic=True).argmax(-1),
            }
            with precision_flags("f32"):
                preds["f32"] = dec.forward_train(params0, feats, inputs, deterministic=True).argmax(-1)
        prev = preds["bf16"][:, :-1].cpu().numpy()
        gold = inputs.cpu().numpy()
        replace = coin & (gold[:, 1:] != 0) & (prev != 0)
        want = gold.copy()
        want[:, 1:] = np.where(replace, prev, gold[:, 1:])
        if len(recorded) != 1 or not coin.all() or not np.array_equal(mixed, want):
            raise AssertionError(f"ss step: eps 1's mixed inputs differ from the host's at "
                                 f"{int((mixed != want).sum())} positions")
        live = (tokens[:, 1:] != 0).cpu().numpy()
        differ = int(((preds["bf16"] != preds["f32"]).cpu().numpy() & live).sum())
    times = {}
    for name, run in (("off", lambda: plain(fresh(), feats, tokens)), ("on", lambda: ss(fresh(), feats, tokens, 0.5))):
        run()
        times[name] = [timed(run)[1] for _ in range(5)]
    log(f"ss step: lstm1 batch {DEC_TRAIN_BATCH} T {MAX_LEN + 1} vocab {VOCAB} bf16 compute, dropout off: eps 0 "
        f"the plain step's update bit for bit; eps 1 replaced {int(replace.sum())} of {int(live[:, :-1].sum())} "
        f"live input positions, the mixed inputs equal the host's from pass 1's argmax (position 0, pads and pad "
        f"predictions kept); pass 1's argmax differs between bf16 and f32 compute at {differ} of {int(live.sum())} "
        f"live positions; loss at eps 1 {float(m1['loss']):.6f} against {float(ma['loss']):.6f}; step ms "
        f"off {[round(t * 1e3, 3) for t in times['off']]} median {np.median(times['off']) * 1e3:.3f}, on (eps 0.5) "
        f"{[round(t * 1e3, 3) for t in times['on']]} median {np.median(times['on']) * 1e3:.3f}")


def scheduled_fit(dev, tokenizer):
    """12(a), the fit: ``fit`` at bf16 with scheduled_sampling P12_SS
    (linear) over P12_EPOCHS epochs and the cider monitor on P12_VAL_ROWS
    rows: the history's ss_eps 0, 0.25, 0.5, finite losses, the monitor's
    K2 and K3 once a decode step. -> (the pipeline, its launches)."""
    from tpucap_torch import ops
    from tpucap_torch.config import TrainConfig

    pipe = decoder_pipeline(tokenizer, TrainConfig(batch_size=DEC_TRAIN_BATCH, precision="bf16",
                                                   scheduled_sampling=P12_SS, val_metric="cider"))
    train = training_corpus(tokenizer, P12_FIT_ROWS, 53)
    val = training_corpus(tokenizer, P12_VAL_ROWS, 54, prefix="val")
    feats = random_features([*train, *val], 55)
    ops.reset_launch_counts()
    hist, wall = timed(lambda: pipe.fit(train, feats, epochs=P12_EPOCHS, val_data=(val, feats), log=None))
    counts = ops.launch_counts()
    eps = [h["ss_eps"] for h in hist]
    if eps != [0.0, 0.25, 0.5] or not all(np.isfinite(h[k]) for h in hist for k in ("loss", "val_loss", "val_cider")):
        raise AssertionError(f"ss fit: history {hist}")
    k2 = check_cli_counts("ss fit monitor", counts, P12_EPOCHS * -(-P12_VAL_ROWS // DEC_TRAIN_BATCH))
    log(f"ss fit: lstm1 batch {DEC_TRAIN_BATCH} bf16, scheduled_sampling {P12_SS} linear, {P12_FIT_ROWS} rows, "
        f"{P12_EPOCHS} epochs: ss_eps {eps}, losses {[round(h['loss'], 4) for h in hist]}, val_cider "
        f"{[round(h['val_cider'], 4) for h in hist]}; {wall:.5f} s; the cider monitor's greedy decode launched K2 "
        f"{k2}, K3 {counts['merge_head']} + {counts['vocab_proj']}")
    return pipe, counts


def interval_saves(spd: int, steps_per_epoch: int, epochs: int, every: int) -> list[tuple[int, bool]]:
    """tpucap's checkpoint steps (fit, ``tpucap/pipeline_training.py:765-
    768, 880-890, 902-906``) as (step, epoch save): at spd 1 every
    multiple of ``every`` inside an epoch; at spd > 1 the first group
    boundary at or past each multiple, the next multiple counted from the
    step saved; the tails save nothing; every epoch's end."""
    out, next_save = [], every
    for e in range(epochs):
        ends = range(1, steps_per_epoch + 1) if spd == 1 else range(spd, steps_per_epoch + 1, spd)
        for b in ends:
            done = e * steps_per_epoch + b
            if b < steps_per_epoch and (done % every == 0 if spd == 1 else done >= next_save):
                out.append((done, False))
                next_save = (done // every + 1) * every
        out.append(((e + 1) * steps_per_epoch, True))
    return out


def dispatch_runs(dev, tokenizer) -> None:
    """12(b): ``fit`` over P12_SPD_EPOCHS epochs of P12_SPD_STEPS steps at
    batch DEC_TRAIN_BATCH, bf16, dropout on, a checkpoint every P12_EVERY
    steps, at each of P12_SPDS steps a dispatch, torch's deterministic
    settings on: the params equal spd 1's bit for bit, each epoch's loss
    within 1e-6 relative, the steps saved (recorded as they happen) the
    ones tpucap's rule gives; each run's wall and ms a step, the saves'
    seconds taken out."""
    import tempfile

    from tpucap_torch.checkpoint import CheckpointManager
    from tpucap_torch.config import TrainConfig

    rows = P12_SPD_STEPS * DEC_TRAIN_BATCH
    train = training_corpus(tokenizer, rows, 56)
    feats = random_features(train, 57)
    steps = P12_SPD_STEPS * P12_SPD_EPOCHS
    saves: list = []

    class Recording(CheckpointManager):
        def save(self, state, metrics=None):
            t0 = time.perf_counter()
            out = super().save(state, metrics=metrics)
            saves.append((int(state.step), metrics is not None, time.perf_counter() - t0))
            return out

    runs = {}
    with tempfile.TemporaryDirectory() as tmp, deterministic_torch("dispatch"):
        for spd in P12_SPDS:
            pipe = decoder_pipeline(tokenizer, TrainConfig(batch_size=DEC_TRAIN_BATCH, precision="bf16",
                                                           steps_per_dispatch=spd, checkpoint_every_steps=P12_EVERY))
            saves.clear()
            mgr = Recording(Path(tmp) / f"spd{spd}", best_metric=None)
            hist, wall = timed(lambda: pipe.fit(train, feats, epochs=P12_SPD_EPOCHS, checkpoint_manager=mgr, log=None))
            got = [(s, e) for s, e, _ in saves]
            want = interval_saves(spd, P12_SPD_STEPS, P12_SPD_EPOCHS, P12_EVERY)
            if got != want:
                raise AssertionError(f"dispatch spd {spd}: saves at {got}, tpucap's rule gives {want}")
            save_s = sum(t for *_, t in saves)
            runs[spd] = dict(params=pipe.params["decoder"], hist=hist, wall=wall, save_s=save_s,
                             interval=[s for s, e in got if not e])
    base = runs[1]
    for spd, r in runs.items():
        worst = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(r["hist"], base["hist"]))
        if not same_tree(r["params"], base["params"]) or worst > 1e-6:
            raise AssertionError(f"dispatch spd {spd}: params differ from spd 1's, or an epoch's loss by {worst:.3g}")
        r["worst"] = worst
    if runs[4]["interval"] != [8, 14, 18] or runs[8]["interval"] != [8, 18]:
        raise AssertionError(f"dispatch: interval saves {runs[4]['interval']} / {runs[8]['interval']}")
    for spd, r in runs.items():
        log(f"dispatch spd {spd}: {P12_SPD_EPOCHS} epochs x {P12_SPD_STEPS} steps, batch {DEC_TRAIN_BATCH} bf16, "
            f"dropout on: params {'equal spd 1' if spd > 1 else 'the reference'}"
            f"{' bit for bit' if spd > 1 else ''}, epoch losses within {r['worst']:.3g} relative; interval saves "
            f"at {r['interval']} and epoch saves at {P12_SPD_STEPS}, {steps} (tpucap's rule); wall {r['wall']:.5f} s, "
            f"saves {r['save_s']:.5f} s, {(r['wall'] - r['save_s']) / steps * 1e3:.3f} ms a step without the saves")


def write_glove(path: Path, tokenizer) -> int:
    """A GloVe-format file of random WIDTH-d vectors for every other word
    of the vocabulary and P12_OOV words outside it. -> the vocabulary's
    words written."""
    rng = np.random.default_rng(58)
    words = list(tokenizer.word_index)[::2] + [f"oov{i}" for i in range(P12_OOV)]
    with open(path, "w") as f:
        for w in words:
            f.write(w + " " + " ".join(f"{v:.6f}" for v in rng.normal(scale=0.1, size=WIDTH)) + "\n")
    return len(words) - P12_OOV


def frozen_embeddings(dev, tokenizer, glove: Path, covered: int) -> dict[str, int]:
    """12(c): ``set_pretrained_embeddings(glove, freeze=True)``, then
    ``fit`` with adamw at weight decay 0.01 (bf16, P12_FROZEN_EPOCHS
    epochs, a checkpoint manager): the table bit for bit before and after,
    every other leaf moved; the checkpoint restored into a template built
    without the freeze. Then ``fit_finetune`` (ViT-B/16 flash + lstm1, batch
    TRAIN_BATCH, bf16, P12_FT_STEPS steps) with the frozen table: the table
    bit for bit, K5, dK/dV and dQ 12 times a step. -> the joint fit's
    launches."""
    import tempfile

    from tpucap_torch import ops
    from tpucap_torch.checkpoint import CheckpointManager
    from tpucap_torch.config import TrainConfig
    from tpucap_torch.core import tree_leaves
    from tpucap_torch.train import TrainState, build_optimizer

    pipe = decoder_pipeline(tokenizer, TrainConfig(batch_size=DEC_TRAIN_BATCH, precision="bf16", optimizer="adamw",
                                                   weight_decay=0.01))
    lines: list = []
    hits, load_s = timed(lambda: pipe.set_pretrained_embeddings(glove, freeze=True, log=lines.append))
    if hits != covered or lines != [f"pretrained embeddings: {hits}/{VOCAB - 1} vocab words covered "
                                    f"({100.0 * hits / (VOCAB - 1):.1f}%), table frozen"]:
        raise AssertionError(f"frozen: {hits} words covered of {covered} written; logged {lines}")
    before = {k: [t.detach().cpu().clone() for t in tree_leaves(v)] for k, v in pipe.params["decoder"].items()}
    train = training_corpus(tokenizer, P12_FIT_ROWS, 59)
    feats = random_features(train, 60)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(Path(tmp), best_metric=None)
        _, fit_s = timed(lambda: pipe.fit(train, feats, epochs=P12_FROZEN_EPOCHS, checkpoint_manager=mgr, log=None))
        after = {k: [t.detach().cpu() for t in tree_leaves(v)] for k, v in pipe.params["decoder"].items()}
        table_same = torch.equal(before["embedding"][0], after["embedding"][0])
        moved = [k for k in before if k != "embedding"
                 and all(not torch.equal(a, b) for a, b in zip(before[k], after[k]))]
        if not table_same or len(moved) != len(before) - 1:
            raise AssertionError(f"frozen fit: table bit for bit {table_same}; moved {moved} of {sorted(before)}")
        template = TrainState.create(pipe.params["decoder"], build_optimizer(pipe.config.train),
                                     torch.Generator(device=dev))
        restored = mgr.restore(template)
        if not same_tree(restored.params, pipe.params["decoder"]):
            raise AssertionError("frozen fit: the checkpoint does not restore into a template without the freeze")
    fpipe = finetune_pipeline(tokenizer, "bf16")
    fpipe.set_pretrained_embeddings(glove, freeze=True, log=None)
    table = fpipe.params["decoder"]["embedding"]["table"].detach().clone()
    desc = training_corpus(tokenizer, TRAIN_BATCH, 61)
    rng = np.random.default_rng(62)
    images = {k: rng.uniform(-1, 1, size=(IMAGE, IMAGE, 3)).astype(np.float32) for k in desc}
    ops.reset_launch_counts()
    hist, ft_s = timed(lambda: fpipe.fit_finetune(desc, images, epochs=P12_FT_STEPS, log=None))
    counts = ops.launch_counts()
    layers = fpipe.encoder.num_layers
    check_launches("frozen finetune", counts, {k: layers * P12_FT_STEPS for k in (
        "flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")}, decode=False)
    if not torch.equal(table, fpipe.params["decoder"]["embedding"]["table"]) or not all(
            np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"frozen finetune: the table moved, or losses {[h['loss'] for h in hist]}")
    log(f"frozen: GloVe file of {covered + P12_OOV} {WIDTH}-d vectors ({P12_OOV} outside the vocabulary) parsed and "
        f"installed in {load_s:.5f} s, {lines[0]!r}; fit adamw weight decay 0.01, bf16, {P12_FROZEN_EPOCHS} epochs "
        f"of {P12_FIT_ROWS // DEC_TRAIN_BATCH} steps {fit_s:.5f} s: the table bit for bit, the other "
        f"{len(moved)} subtrees moved, the checkpoint restored into a template without the freeze; fit_finetune "
        f"{fpipe.config.encoder.name} flash + lstm1 batch {TRAIN_BATCH} bf16, {P12_FT_STEPS} steps {ft_s:.5f} s: "
        f"the table bit for bit, launches {layers} each of K5, dK/dV, dQ a step")
    return counts


def score_against_engine(pipe) -> dict[str, int]:
    """12(d): on 12(a)'s trained pipeline, P12_SCORE_ROWS rows: the score of
    each greedy caption (``score_captions``: ``forward_train``, the plain
    cell) against the greedy engine's score (the fused step, K2 and K3), at
    f32 with TF32 off within 1e-4, then at bf16 (reported); rows whose
    greedy decode did not end have no closing term in the engine's score
    and are left out (counted). ``score_captions``' ms for the rows. -> the
    decodes' launches."""
    from tpucap_torch import ops

    x = np.stack(list(random_features(range(P12_SCORE_ROWS), 63).values()))
    total = None
    report = {}
    for precision in ("f32", "bf16"):
        pipe.config = dataclasses.replace(pipe.config, precision=precision)
        pipe._bf16_params = None
        ops.reset_launch_counts()
        with torch.inference_mode():
            res = pipe._decode(pipe._inference_params()["decoder"], torch.from_numpy(x).to(pipe.device,
                               pipe._infer_dtype()), "greedy", 1)
        counts = ops.launch_counts()
        steps = check_cli_counts(f"score {precision} generate", counts, 1)
        total = counts if total is None else {k: total[k] + counts[k] for k in counts}
        caps = pipe._captions(res)
        ended = (res.lengths < MAX_LEN).cpu().numpy() | (res.tokens[:, -1] == pipe._token_ids()[1]).cpu().numpy()
        rows = [i for i in range(P12_SCORE_ROWS) if ended[i]]
        scores, _ = timed(lambda: pipe.score_captions(x[rows], [caps[i] for i in rows]))
        times = [timed(lambda: pipe.score_captions(x[rows], [caps[i] for i in rows]))[1] for _ in range(3)]
        if any(ops.launch_counts()[k] != counts[k] for k in counts):
            raise AssertionError("score: score_captions launched a kernel")
        err = float(np.abs(np.array([s["logp"] for s in scores]) - res.scores.float().cpu().numpy()[rows]).max())
        if not rows or (precision == "f32" and err > 1e-4):
            raise AssertionError(f"score {precision}: {len(rows)} rows ended, largest difference {err}")
        report[precision] = (len(rows), err, steps, float(np.median(times)))
    pipe.config = dataclasses.replace(pipe.config, precision="f32")
    pipe._bf16_params = None
    (n32, e32, s32, t32), (n16, e16, s16, t16) = report["f32"], report["bf16"]
    log(f"score: score_captions(f, generate(f, greedy)) against the greedy engine's score, {P12_SCORE_ROWS} rows: "
        f"f32 (TF32 off) {n32} rows ended, largest difference {e32:.3g} (bound 1e-4; the engine K2 and K3 "
        f"{s32} steps); bf16 {n16} rows ended, largest difference {e16:.3g} (no bound; {s16} steps); "
        f"score_captions ms for {n32} rows f32 {t32 * 1e3:.3f}, bf16 {t16 * 1e3:.3f} (median of 3)")
    return total


def slice_cli(dev, glove: Path) -> dict[str, int]:
    """12(e): the CLI on phase 8's dataset: ``extract``, ``train
    --scheduled-sampling 0.5 --ss-schedule inv_sigmoid --steps-per-dispatch
    P12_CLI_SPD --embeddings FILE --freeze-embeddings`` (P12_CLI_EPOCHS
    epochs): every checkpoint's table the file's matrix; ``score --image`` of
    P12_SCORED images with ``--captions-file``: tpucap's line for each, those
    of ``score_captions`` on the restored pipeline (host preprocessing, as
    tpucap's extract_features: no kernel); ``evaluate --dump-captions`` with
    ``--average-last`` 1 and 2, then ``compare --metric cider`` of the two
    dumps: its JSON that of ``compare_caption_files``. -> the evaluates'
    launches."""
    import re
    import tempfile

    from tpucap_torch import ops
    from tpucap_torch.checkpoint import CheckpointManager
    from tpucap_torch.cli.main import _build_config, _restore_pipeline, build_parser
    from tpucap_torch.data import load_descriptions, load_split, prepare_descriptions
    from tpucap_torch.pipeline import CaptioningPipeline
    from tpucap_torch.text import load_tokenizer
    from tpucap_torch.train import TrainState, build_optimizer
    from tpucap_torch.train.compare import compare_caption_files

    flags = ["--scheduled-sampling", 0.5, "--ss-schedule", "inv_sigmoid", "--steps-per-dispatch", P12_CLI_SPD,
             "--embeddings", glove, "--freeze-embeddings"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ids = write_cli_dataset(root)
        feats_path, ckpt = root / "features.npz", root / "ckpt"
        run_cli(["extract", *CLI_MODEL, "--images", root / "images", "--out", feats_path, "--batch-size",
                 CLI_EXTRACT_BATCH])
        train = ["train", *CLI_MODEL, "--tokens", root / "tokens.txt", "--split", root / "train.txt", "--features",
                 feats_path, "--checkpoint-dir", ckpt, "--epochs", P12_CLI_EPOCHS, "--batch-size", CLI_TRAIN_BATCH,
                 *flags]
        out, _, train_s, _ = run_cli(train)
        lines = [line for _, line in out]
        coverage = lines[0]
        if not coverage.startswith("pretrained embeddings: ") or not coverage.endswith(", table frozen") or not \
                lines[-1].startswith(f"trained {P12_CLI_EPOCHS} epochs; final loss "):
            raise AssertionError(f"cli slice train: printed {lines}")
        cfg = _build_config(build_parser()[0].parse_args([str(a) for a in train]))
        t = cfg.train
        if (t.scheduled_sampling, t.ss_schedule, t.steps_per_dispatch) != (0.5, "inv_sigmoid", P12_CLI_SPD):
            raise AssertionError(f"cli slice train: the flags did not reach the config: {t}")
        ref = CaptioningPipeline(cfg, tokenizer=load_tokenizer(ckpt / "tokenizer.json"), device=dev)
        ref.build(init_params=False)
        ref.set_params({"encoder": {}, "decoder": ref.decoder.init(torch.Generator().manual_seed(0))})
        ref.set_pretrained_embeddings(glove, log=None)
        want = ref.params["decoder"]["embedding"]["table"]
        mgr = CheckpointManager(ckpt, best_metric=None)
        template = TrainState.create(ref.params["decoder"], build_optimizer(t), torch.Generator(device=dev))
        kept = mgr.all_steps()
        if len(kept) != P12_CLI_EPOCHS or not all(
                torch.equal(mgr.restore(template, s).params["embedding"]["table"], want) for s in kept):
            raise AssertionError(f"cli slice train: checkpoints {kept}; a table differs from the file's matrix")
        del ref, template

        test = prepare_descriptions(load_descriptions(root / "tokens.txt"), load_split(root / "test.txt"))
        picked = list(test)[:P12_SCORED]
        caps = [test[k][0].removeprefix("startseq ").removesuffix(" endseq") for k in picked]
        (root / "captions.txt").write_text("\n".join(caps) + "\n")
        images = [str(root / "images" / f"{k}.jpg") for k in picked]
        score = ["score", *CLI_MODEL, "--image", *images, "--captions-file", root / "captions.txt",
                 "--checkpoint-dir", ckpt]
        ops.reset_launch_counts()
        out, _, score_s, _ = run_cli(score)
        counts = ops.launch_counts()
        lines = [line for _, line in out]
        pipe = _restore_pipeline(build_parser()[0].parse_args([str(a) for a in score]), dev)
        scores = pipe.score_captions(pipe.extract_features(images), caps)
        del pipe
        expect = [f"{p}\tlogp={s['logp']:.4f}\tppl={s['perplexity']:.3f}\ttokens={s['tokens']}\t{c}"
                  for p, c, s in zip(images, caps, scores)]
        form = re.compile(r"[^\t]+\tlogp=-?\d+\.\d{4}\tppl=\d+\.\d{3}\ttokens=\d+\t.*")
        if lines != expect or not all(form.fullmatch(line) for line in lines) or any(counts.values()):
            raise AssertionError(f"cli slice score: printed {lines}, in-process {expect}, launches {counts}")

        dumps, ev, ev_s = [], dict.fromkeys(counts, 0), []
        for k in (1, 2):
            dump = root / f"dump{k}.jsonl"
            ops.reset_launch_counts()
            *_, eval_s, _ = run_cli(["evaluate", *CLI_MODEL, "--tokens", root / "tokens.txt", "--split",
                                     root / "test.txt", "--features", feats_path, "--checkpoint-dir", ckpt,
                                     "--average-last", k, "--batch-size", CLI_TRAIN_BATCH, "--dump-captions", dump])
            c = ops.launch_counts()
            ev_s.append(eval_s)
            check_cli_counts(f"cli slice evaluate --average-last {k}", c, 1)
            ev = {name: ev[name] + c[name] for name in ev}
            dumps.append(dump)
        out, err, compare_s, _ = run_cli(["compare", *dumps, "--metric", "cider"])
        got = json.loads(out[-1][1])
        want_cmp = compare_caption_files(str(dumps[0]), str(dumps[1]), metric="cider")
        if got != json.loads(json.dumps(want_cmp)) or not err[0].startswith("# cider: A="):
            raise AssertionError(f"cli slice compare: {got} against compare_caption_files' {want_cmp}; stderr {err}")
        log(f"cli slice: {' '.join(CLI_MODEL)} train {' '.join(str(a) for a in flags[:6])} --embeddings FILE "
            f"--freeze-embeddings, {P12_CLI_EPOCHS} epochs: {train_s:.5f} s, {coverage!r}, "
            f"every checkpoint's table the file's matrix; score --image of {P12_SCORED} images {score_s:.5f} s, "
            f"the lines of score_captions on the restored pipeline, no kernel (host preprocessing, VGG16's plain "
            f"convolutions, forward_train's plain cell), e.g. {expect[0].split(chr(9), 1)[1]!r}; evaluate "
            f"--dump-captions --average-last 1 and 2 {ev_s[0]:.5f} and {ev_s[1]:.5f} s (K2 {ev['lstm_cell']}, K3 "
            f"{ev['merge_head']} + {ev['vocab_proj']}); compare {compare_s:.5f} s: {err[0]!r}, its JSON "
            f"compare_caption_files'")
    return ev


def run_slice8(dev, tokenizer) -> dict[str, int]:
    """Phase 12. -> the counted runs' launches."""
    import tempfile

    scheduled_step(dev, tokenizer)
    pipe, fit_counts = scheduled_fit(dev, tokenizer)
    dispatch_runs(dev, tokenizer)
    with tempfile.TemporaryDirectory() as tmp:
        glove = Path(tmp) / "glove.txt"
        covered = write_glove(glove, tokenizer)
        frozen = frozen_embeddings(dev, tokenizer, glove, covered)
        scored = score_against_engine(pipe)
        del pipe
        cli = slice_cli(dev, glove)
    return {k: fit_counts[k] + frozen[k] + scored[k] + cli[k] for k in cli}


# -- phase 13: streamed training input and LoRA --------------------------------

# (a) Flickr8k's train split: images, captions an image, the step of the
# cut, the group size; (b) fit_lora's rows, rank and epochs, the rows
# decoded; (c) the joint LoRA fit's steps; (d) the CLI's epochs.
P13_IMAGES, P13_REFS, P13_CUT, P13_SPD = 6000, 5, 50, 4
P13_LORA_ROWS, P13_RANK, P13_LORA_EPOCHS, P13_DECODED = 2048, 8, 2, 256
P13_FT_STEPS, P13_CLI_EPOCHS = 4, 2
#: tpucap's refusal of --lora-rank with --stream-features (tpucap/cli/main.py:589-614).
P13_REFUSAL = ("--lora-rank does not compose with --stream-features (the adapters ARE the "
               "memory/monitoring fix; train full weights for those dials)")


def host_peak(fn) -> tuple[object, float]:
    """``fn()`` under tracemalloc: -> (its result, the peak MiB of the host
    allocations traced during the call, numpy's arrays among them)."""
    import tracemalloc

    tracemalloc.start()
    try:
        out = fn()
        return out, tracemalloc.get_traced_memory()[1] / 2**20
    finally:
        tracemalloc.stop()


class GuardAfter:
    """A preemption guard that fires on its ``n``-th query: the loop asks
    once a step, so the run is cut after step ``n``."""

    def __init__(self, n: int):
        self.n, self.calls = n, 0

    @property
    def fired(self) -> bool:
        self.calls += 1
        return self.calls >= self.n


def stream_runs(dev, tokenizer) -> None:
    """13(a): Flickr8k's train split (P13_IMAGES ids x P13_REFS captions,
    pooled 2048-d f32 rows written uncompressed by ``np.savez``), one
    epoch of ``fit`` at batch DEC_TRAIN_BATCH, bf16, dropout on: the
    streamed run on the lazy ``np.load`` handle against the in-memory one,
    params and history bit for bit; each call's host peak (tracemalloc, in
    runs of their own) and ms a step; a streamed run cut after step
    P13_CUT and resumed: the uncut streamed params bit for bit; the stream
    at steps_per_dispatch P13_SPD: spd 1's params bit for bit."""
    import tempfile

    from tpucap_torch.checkpoint import CheckpointManager
    from tpucap_torch.config import TrainConfig

    train = TrainConfig(batch_size=DEC_TRAIN_BATCH, precision="bf16")
    desc = training_corpus(tokenizer, P13_IMAGES, 70, refs=P13_REFS)
    feats = random_features(desc, 71)
    rows = P13_IMAGES * P13_REFS
    steps = rows // DEC_TRAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "features.npz"
        np.savez(path, **feats)
        mb = path.stat().st_size / 1e6

        def run(stream: bool, **kw):
            pipe = decoder_pipeline(tokenizer, dataclasses.replace(train, **kw.pop("train", {})))
            if not stream:
                return pipe, pipe.fit(desc, feats, epochs=1, log=None, **kw)
            with np.load(path) as handle:
                return pipe, pipe.fit(desc, handle, epochs=1, stream=True, log=None, **kw)

        (memory, mem_hist), mem_peak = host_peak(lambda: run(False))
        (streamed, str_hist), str_peak = host_peak(lambda: run(True))
        if mem_hist != str_hist or not same_tree(memory.params, streamed.params):
            raise AssertionError(f"stream: history {str_hist} or params differ from the in-memory run's {mem_hist}")
        del memory
        _, mem_s = timed(lambda: run(False))
        _, str_s = timed(lambda: run(True))
        mgr = CheckpointManager(Path(tmp) / "ckpt", best_metric=None)
        _, cut_hist = run(True, checkpoint_manager=mgr, preemption_guard=GuardAfter(P13_CUT))
        if not cut_hist[-1].get("preempted") or mgr.latest_step() != P13_CUT:
            raise AssertionError(f"stream cut: history {cut_hist}, latest step {mgr.latest_step()}")
        resumed, resume_s = timed(lambda: run(True, checkpoint_manager=mgr, resume=True)[0])
        if not same_tree(resumed.params, streamed.params):
            raise AssertionError("stream resume: the resumed params differ from the uncut streamed run's")
        del resumed
        (grouped, _), spd_s = timed(lambda: run(True, train=dict(steps_per_dispatch=P13_SPD)))
        if not same_tree(grouped.params, streamed.params):
            raise AssertionError(f"stream spd {P13_SPD}: the params differ from spd 1's")
        del grouped, streamed
    log(f"stream: {P13_IMAGES} images x {P13_REFS} captions ({rows} rows, {steps} steps of {DEC_TRAIN_BATCH}), "
        f"lstm1 vocab {VOCAB} bf16, dropout on, features.npz {mb:.1f} MB (np.savez, uncompressed): fit(stream=True) "
        f"on the lazy np.load handle gives fit(stream=False)'s params and history bit for bit; host peak "
        f"(tracemalloc) in-memory {mem_peak:.1f} MiB, streamed {str_peak:.1f} MiB; ms a step in-memory "
        f"{mem_s / steps * 1e3:.3f}, streamed {str_s / steps * 1e3:.3f} (wall of fit over its steps, the token "
        f"build included); cut after step {P13_CUT} and resumed ({resume_s:.5f} s): the uncut streamed params "
        f"bit for bit; steps_per_dispatch {P13_SPD} on the stream {spd_s / steps * 1e3:.3f} ms a step: spd 1's "
        f"params bit for bit; epoch loss {str_hist[0]['loss']:.6f}")


def lora_fit(dev, tokenizer) -> dict[str, int]:
    """13(b): ``fit_lora`` at the main path's widths (lstm1, vocab VOCAB,
    batch DEC_TRAIN_BATCH, bf16, rank P13_RANK) on P13_LORA_ROWS rows: the
    first step's loss the base model's on that batch; after the fit the
    base tree bit for bit, every adapter moved, the logged trainable share
    ``lora_param_counts``'; greedy on the merged decoder equals greedy on
    ``apply_lora``'s view, K2 = K3 once a step; ms a step beside ``fit``'s
    on the same data; ``save_lora`` then ``apply_lora_file`` into a fresh
    pipeline: the merged params bit for bit, the artifact's size. -> the
    decodes' launches."""
    import tempfile

    from tpucap_torch import ops
    from tpucap_torch.config import TrainConfig
    from tpucap_torch.core import precision_flags, tree_map
    from tpucap_torch.train import TrainState, build_optimizer, build_training_batch, make_eval_step
    from tpucap_torch.train.lora import apply_lora, init_lora, lora_param_counts, make_lora_train_step

    train = TrainConfig(batch_size=DEC_TRAIN_BATCH, precision="bf16")
    desc = training_corpus(tokenizer, P13_LORA_ROWS, 72)
    feats = random_features(desc, 73)
    steps = P13_LORA_ROWS // DEC_TRAIN_BATCH * P13_LORA_EPOCHS
    scale = 1.0
    pipe = decoder_pipeline(tokenizer, train, precision="bf16")
    base = pipe.params["decoder"]
    before = tree_map(torch.clone, base)
    # The first step against the base model's loss on the same batch.
    F, T = build_training_batch(tokenizer, desc, feats, MAX_LEN)
    f0, t0 = pipe._to_device(F[:DEC_TRAIN_BATCH], T[:DEC_TRAIN_BATCH])
    init = init_lora(base, P13_RANK, generator=torch.Generator().manual_seed(train.seed + 7))
    opt = build_optimizer(train)
    step = make_lora_train_step(pipe.decoder, base, opt, scale=scale, deterministic=True,
                                compute_dtype=torch.bfloat16)
    with precision_flags("bf16"):
        _, m = step(TrainState.create(tree_map(torch.clone, init), opt, torch.Generator(device=dev)), f0, t0)
        want = make_eval_step(pipe.decoder, compute_dtype=torch.bfloat16)(base, f0, t0)
    first, base_loss = float(m["loss"]), float(want["loss"])
    if abs(first - base_loss) > 1e-6 * abs(base_loss):
        raise AssertionError(f"lora: the first step's loss {first} is not the base model's {base_loss}")
    lines: list = []
    hist, lora_s = timed(lambda: pipe.fit_lora(desc, feats, rank=P13_RANK, epochs=P13_LORA_EPOCHS,
                                               log=lines.append))
    if not same_tree(base, before):
        raise AssertionError("lora: the base tree moved")
    adapters = pipe.lora_adapters
    unmoved = [k for k in adapters if torch.equal(adapters[k]["a"], init[k]["a"]) or not adapters[k]["b"].any()]
    n_ad, n_base = lora_param_counts(base, adapters)
    share = f"LoRA rank {P13_RANK}: {n_ad:,} trainable / {n_base:,} frozen params ({100.0 * n_ad / n_base:.2f}%)"
    if unmoved or lines[0] != share or not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"lora: unmoved adapters {unmoved}; logged {lines}; history {hist}")
    plain = decoder_pipeline(tokenizer, train, precision="bf16")
    _, fit_s = timed(lambda: plain.fit(desc, feats, epochs=P13_LORA_EPOCHS, log=None))
    del plain
    # Greedy on the merged decoder, then on apply_lora's view (the step's
    # own computation, with autograd on).
    x = np.stack([feats[k] for k in list(desc)[:P13_DECODED]])
    merged = pipe.params["decoder"]
    ops.reset_launch_counts()
    on_merged = pipe.generate(x, method="greedy")
    c_merged = ops.launch_counts()
    with precision_flags(pipe.config.precision):
        live = tree_map(lambda t: t.detach().requires_grad_(True), adapters)
        view = tree_map(lambda t: t.detach(), apply_lora(base, live, scale=scale))
    pipe.params["decoder"], pipe._bf16_params = view, None
    ops.reset_launch_counts()
    on_view = pipe.generate(x, method="greedy")
    c_view = ops.launch_counts()
    pipe.params["decoder"], pipe._bf16_params = merged, None
    k2 = check_cli_counts("lora merged decode", c_merged, 1)
    check_cli_counts("lora view decode", c_view, 1)
    if on_merged != on_view or c_merged != c_view:
        same = sum(a == b for a, b in zip(on_merged, on_view))
        raise AssertionError(f"lora: {same} of {len(on_view)} merged captions equal the view's")
    with tempfile.TemporaryDirectory() as tmp:
        art = Path(tmp) / "adapters.npz"
        _, save_s = timed(lambda: pipe.save_lora(art))
        fresh = decoder_pipeline(tokenizer, train, precision="bf16")
        _, apply_s = timed(lambda: fresh.apply_lora_file(art))
        if not same_tree(fresh.params["decoder"], merged):
            raise AssertionError("lora: apply_lora_file's merged params differ from fit_lora's")
        art_mb = art.stat().st_size / 1e6
        del fresh
    log(f"lora fit: lstm1 vocab {VOCAB} batch {DEC_TRAIN_BATCH} bf16, rank {P13_RANK}, {P13_LORA_ROWS} rows x "
        f"{P13_LORA_EPOCHS} epochs: the first step's loss {first:.6f}, the base model's {base_loss:.6f}"
        f"{' (bit for bit)' if first == base_loss else ''}; {lines[0]!r}; the base tree bit for bit, all "
        f"{len(adapters)} adapters moved; losses {[round(h['loss'], 4) for h in hist]}; ms a step fit_lora "
        f"{lora_s / steps * 1e3:.3f}, fit {fit_s / steps * 1e3:.3f} (wall over the steps); greedy of "
        f"{P13_DECODED} rows on the merged decoder equals greedy on apply_lora's view, caption for caption, K2 "
        f"{k2}, K3 {c_merged['merge_head']} + {c_merged['vocab_proj']} each; save_lora {save_s:.5f} s, "
        f"apply_lora_file into a fresh pipeline {apply_s:.5f} s: the merged params bit for bit; artifact "
        f"{art_mb:.3f} MB")
    return {k: c_merged[k] + c_view[k] for k in c_merged}


def lora_finetune(dev, tokenizer) -> dict[str, int]:
    """13(c): ``fit_finetune(lora_rank=P13_RANK)`` on ViT-B/16 (flash) at
    IMAGE + lstm1, batch TRAIN_BATCH, f32 and bf16, P13_FT_STEPS steps on
    one batch after a warm-up: counters reset just before and read just
    after, 12 launches each of K5, dK/dV and dQ a step, the loss
    descending, the base encoder and decoder bit for bit; ms a step and
    peak memory; then ``freeze_encoder=True``: no adapter under the
    encoder, its launches. -> the counted runs' launches."""
    from tpucap_torch import ops
    from tpucap_torch.core import tree_map

    desc = training_corpus(tokenizer, TRAIN_BATCH, 74)
    rng = np.random.default_rng(75)
    images = {k: rng.uniform(-1, 1, size=(IMAGE, IMAGE, 3)).astype(np.float32) for k in desc}
    total = None
    flash = ("flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    for precision in ("f32", "bf16"):
        pipe = finetune_pipeline(tokenizer, precision)
        layers = pipe.encoder.num_layers
        pipe.fit_finetune(desc, images, epochs=1, lora_rank=P13_RANK, log=None)  # warm-up
        base = {k: pipe.params[k] for k in ("encoder", "decoder")}
        before = tree_map(torch.clone, base)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        lines: list = []
        hist, s = timed(lambda: pipe.fit_finetune(desc, images, epochs=P13_FT_STEPS, lora_rank=P13_RANK,
                                                  log=lines.append))
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_launches(f"lora finetune {precision}", counts, {k: layers * P13_FT_STEPS for k in flash},
                       decode=False)
        losses = [h["loss"] for h in hist]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or not same_tree(base, before):
            raise AssertionError(f"lora finetune {precision}: losses {losses}, or the base moved")
        enc_ad = sum(k.startswith("['encoder']") for k in pipe.lora_adapters)
        total = counts if total is None else {k: total[k] + counts[k] for k in counts}
        log(f"lora finetune {precision}: {pipe.config.encoder.name} flash + lstm1 batch {TRAIN_BATCH} vocab {VOCAB}, rank {P13_RANK}, "
            f"{P13_FT_STEPS} steps on one batch: step ms {s / P13_FT_STEPS * 1e3:.3f} (wall of fit_finetune over "
            f"its steps); peak memory {peak:.3f} GiB; launches a step "
            f"{ {k: v // P13_FT_STEPS for k, v in counts.items() if v} }; losses {[round(x, 4) for x in losses]}; "
            f"the base bit for bit; {lines[0]!r}, {enc_ad} of {len(pipe.lora_adapters)} adapters under the encoder")
        if precision == "bf16":
            ops.reset_launch_counts()
            hist, s = timed(lambda: pipe.fit_finetune(desc, images, epochs=1, lora_rank=P13_RANK,
                                                      freeze_encoder=True, log=None))
            frozen = ops.launch_counts()
            if any(k.startswith("['encoder']") for k in pipe.lora_adapters) or not np.isfinite(hist[0]["loss"]):
                raise AssertionError(f"lora finetune freeze_encoder: adapters {list(pipe.lora_adapters)}")
            check_launches("lora finetune freeze_encoder", frozen, {"flash_attention": layers}, decode=False)
            total = {k: total[k] + frozen[k] for k in total}
            log(f"lora finetune bf16 freeze_encoder: {len(pipe.lora_adapters)} adapters, none under the encoder; "
                f"one step {s * 1e3:.3f} ms; launches {({k: v for k, v in frozen.items() if v})} (no gradient "
                f"reaches the encoder)")
        del pipe
    return total


def lora_cli(dev) -> dict[str, int]:
    """13(d): the CLI on phase 8's dataset (``--preset config1``):
    ``extract``; ``train --lora-rank P13_RANK --lora-out FILE``: tpucap's
    lines, the bundle's decoder the config seed's merged with the artifact
    (``apply_lora_file``) bit for bit; ``CaptioningPipeline.load`` of the
    bundle captions CLI_CAPTIONED images with beam 3 (K2 = K3 once a
    step); ``train --stream-features`` against ``train``: the same bundle
    bit for bit; ``--lora-rank`` with ``--stream-features`` exits with
    tpucap's message. -> the caption's launches."""
    import tempfile

    from tpucap_torch import ops
    from tpucap_torch.cli.main import _build_config, build_parser
    from tpucap_torch.pipeline import CaptioningPipeline
    from tpucap_torch.text import load_tokenizer

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ids = write_cli_dataset(root)
        feats_path = root / "features.npz"
        run_cli(["extract", *CLI_MODEL, "--images", root / "images", "--out", feats_path, "--batch-size",
                 CLI_EXTRACT_BATCH])
        common = ["train", *CLI_MODEL, "--tokens", root / "tokens.txt", "--split", root / "train.txt",
                  "--features", feats_path, "--epochs", P13_CLI_EPOCHS, "--batch-size", CLI_TRAIN_BATCH]
        ckpt, art = root / "lora", root / "adapters.npz"
        lora_argv = [*common, "--checkpoint-dir", ckpt, "--lora-rank", P13_RANK, "--lora-out", art]
        out, _, lora_s, _ = run_cli(lora_argv)
        lines = [line for _, line in out]
        form = [line.split(":")[0] for line in lines[:-2]]
        if form != [f"LoRA rank {P13_RANK}"] + [f"lora epoch {e}" for e in range(P13_CLI_EPOCHS)] or lines[-2] != \
                f"LoRA adapters in {art}" or not lines[-1].startswith(f"lora-trained {P13_CLI_EPOCHS} epochs; ") or \
                not lines[-1].endswith(f"bundle in {ckpt / 'bundle'}"):
            raise AssertionError(f"cli lora train: printed {lines}")
        bundle = CaptioningPipeline.load(ckpt / "bundle")
        cfg = _build_config(build_parser()[0].parse_args([str(a) for a in lora_argv]))
        ref = CaptioningPipeline(cfg, tokenizer=load_tokenizer(ckpt / "tokenizer.json"), device=dev)
        ref.build()
        ref.apply_lora_file(art)
        if not same_tree(ref.params["decoder"], bundle.params["decoder"]):
            raise AssertionError("cli lora: the bundle's decoder is not the config seed's merged with the artifact")
        del ref
        picked = [root / "images" / f"{k}.jpg" for k in ids[:CLI_CAPTIONED]]
        ops.reset_launch_counts()
        caps, caption_s = timed(lambda: bundle.caption_images(picked, method="beam", beam_width=BEAM))
        counts = ops.launch_counts()
        k2 = check_cli_counts("cli lora caption", counts, 1)
        if len(caps) != CLI_CAPTIONED:
            raise AssertionError(f"cli lora caption: {caps}")
        del bundle
        walls = {}
        for name, extra in (("memory", []), ("stream", ["--stream-features"])):
            _, _, walls[name], _ = run_cli([*common, "--checkpoint-dir", root / name, "--bundle-out",
                                            root / name / "bundle", *extra])
        a = CaptioningPipeline.load(root / "memory" / "bundle")
        b = CaptioningPipeline.load(root / "stream" / "bundle")
        if not same_tree(a.params, b.params):
            raise AssertionError("cli stream: the --stream-features bundle differs from the in-memory one")
        del a, b
        try:
            run_cli([*common, "--checkpoint-dir", root / "refused", "--lora-rank", P13_RANK, "--stream-features"])
        except SystemExit as e:
            refusal = e.code
        else:
            raise AssertionError("cli: --lora-rank with --stream-features ran")
        if refusal != P13_REFUSAL:
            raise AssertionError(f"cli: the refusal {refusal!r} is not tpucap's")
    log(f"cli lora: {' '.join(CLI_MODEL)} train --lora-rank {P13_RANK} --lora-out FILE, {P13_CLI_EPOCHS} epochs: "
        f"{lora_s:.5f} s, printed {lines[0]!r} ... {lines[-1]!r}; the bundle's decoder the config seed's merged "
        f"with the artifact (apply_lora_file) bit for bit; CaptioningPipeline.load(bundle).caption_images of "
        f"{CLI_CAPTIONED} images beam {BEAM} {caption_s:.5f} s, K2 {k2}, K3 {counts['merge_head']} + "
        f"{counts['vocab_proj']}, e.g. {caps[0]!r}; train --stream-features {walls['stream']:.5f} s against train "
        f"{walls['memory']:.5f} s: the same bundle bit for bit; --lora-rank with --stream-features exits: "
        f"{refusal!r}")
    return counts


def run_slice9(dev, tokenizer) -> dict[str, int]:
    """Phase 13, under torch's deterministic settings. -> the counted runs'
    launches."""
    with deterministic_torch("phase 13"):
        stream_runs(dev, tokenizer)
        fitted = lora_fit(dev, tokenizer)
        tuned = lora_finetune(dev, tokenizer)
        cli = lora_cli(dev)
    return {k: fitted[k] + tuned[k] + cli[k] for k in cli}


# -- phase 14: Keras .h5 import and export -----------------------------------

# The encoders' seed; train's epochs before caption / score / export; the
# fine-tune's training ids (13 x 5 captions: one joint step at batch 64);
# the decodes of the re-imported decoders.
P14_SEED, P14_CLI_EPOCHS, P14_FT_IDS, P14_DECODED = 14, 1, 13, 256


def seeded_encoder(arch: str):
    """``arch``'s encoder (its full width) from P14_SEED in tpucap's layout
    (numpy, conv kernels HWIO), every BatchNormalization given seeded
    statistics so that an importer that swapped two of them would show."""
    from tpucap_torch.convert import params_to_numpy
    from tpucap_torch.models.encoders import build_encoder

    tree = params_to_numpy(build_encoder(arch).init(torch.Generator().manual_seed(P14_SEED)))
    rng = np.random.default_rng(P14_SEED)

    def stats(node):
        if isinstance(node, dict):
            if {"beta", "mean", "var"} <= set(node):
                for k, v in node.items():
                    lo_hi = k in ("gamma", "var")
                    node[k] = (rng.uniform(0.5, 1.5, v.shape) if lo_hi else rng.normal(0, 0.1, v.shape)
                               ).astype(np.float32)
            for v in node.values():
                stats(v)

    stats(tree)
    return tree


def keras_encoder_model(arch: str, tree):
    """The records of a Keras full-model file holding ``tree`` as
    ``tf_keras.applications`` names it: each Conv2D, BatchNormalization and
    Dense layer with its weights under Keras's weight names and, in
    ``model_config``, its class and the config keys the importers read
    (``use_bias``, ``scale``, ``center``). VGG16 in the application's layer
    order with its pools, flatten and 1000-way predictions head (a 553 MB
    file at full width); ResNet-50 in its params' order; InceptionV3 under
    Keras's auto-names (``conv2d_7``, ``batch_normalization_7``) in a
    seeded order that is not their creation order."""
    from tpucap_torch.checkpoint import KerasModel

    entries, layers = [], []

    def add(cls, name, weights=(), **config):
        entries.append({"class_name": cls, "name": name, "inbound_nodes": [],
                        "config": {"name": name, "trainable": True, "dtype": "float32", **config}})
        layers.append((name, [(f"{name}/{w}:0", np.asarray(a, np.float32)) for w, a in weights]))

    def conv(name, p):
        ws = [("kernel", p["kernel"])] + ([("bias", p["bias"])] if "bias" in p else [])
        add("Conv2D", name, ws, use_bias="bias" in p)

    def bn(name, p):
        ws = ([("gamma", p["gamma"])] if "gamma" in p else []) + [
            ("beta", p["beta"]), ("moving_mean", p["mean"]), ("moving_variance", p["var"])]
        add("BatchNormalization", name, ws, scale="gamma" in p, center=True)

    add("InputLayer", "input_1")
    if arch == "vgg16":
        rng = np.random.default_rng(P14_SEED)
        for blk in range(1, 6):
            for name in sorted(k for k in tree if k.startswith(f"block{blk}_")):
                conv(name, tree[name])
            add("MaxPooling2D", f"block{blk}_pool")
        add("Flatten", "flatten")
        for name in ("fc1", "fc2"):
            add("Dense", name, [("kernel", tree[name]["kernel"]), ("bias", tree[name]["bias"])])
        head = (rng.normal(0, 0.01, (4096, 1000)), np.zeros(1000))
        add("Dense", "predictions", [("kernel", head[0]), ("bias", head[1])])
    elif arch == "resnet50":
        for name, p in tree.items():
            (bn if name.endswith("_bn") else conv)(name, p)
    else:
        order = np.random.default_rng(P14_SEED).permutation(len(tree))
        for i in order:
            suffix = f"_{i}" if i else ""
            conv(f"conv2d{suffix}", tree[f"conv_{i}"]["conv"])
            bn(f"batch_normalization{suffix}", tree[f"conv_{i}"]["bn"])
    config = {"class_name": "Functional", "config": {
        "name": arch, "trainable": True, "layers": entries, "input_layers": [["input_1", 0, 0]],
        "output_layers": [[entries[-1]["name"], 0, 0]]}}
    return KerasModel(config, layers)


def same_numpy_tree(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(same_numpy_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            same_numpy_tree(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def write_keras_encoders(root: Path) -> tuple[dict, dict]:
    """14: the three encoders' files, each written, read back (the read
    timed: a warm read, the file just written) and imported; the imported
    tree the written one bit for bit. -> (trees, paths)."""
    from tpucap_torch.checkpoint import KerasH5Model, params_from_keras

    trees, paths = {}, {}
    for arch in ("vgg16", "resnet50", "inception_v3"):
        trees[arch] = tree = seeded_encoder(arch)
        path = paths[arch] = root / f"{arch}.h5"
        model = keras_encoder_model(arch, tree)
        _, write_s = timed(lambda: model.save(path))
        size = path.stat().st_size
        view, read_s = timed(lambda: KerasH5Model(path))
        got, import_s = timed(lambda: params_from_keras(path, arch))
        if not same_numpy_tree(got, tree):
            raise AssertionError(f"keras {arch}: the imported tree differs from the one written")
        n = sum(len(layer.get_weights()) for layer in view.layers)
        log(f"keras {arch}: {len(view.layers)} layers, {n} weights, {size / 2**20:.2f} MiB written in "
            f"{write_s:.5f} s; KerasH5Model read {read_s:.5f} s ({size / 2**20 / read_s:.1f} MiB/s, warm: "
            f"the file just written), params_from_keras {import_s:.5f} s; the tree bit for bit")
        del model, view, got
    return trees, paths


def keras_cli(dev, root: Path, tree, h5: Path) -> tuple[dict[str, int], Path, object, np.ndarray]:
    """14(a): the CLI on phase 8's dataset with the VGG16 file: ``extract
    --keras-h5`` bit for bit ``extract_features`` of a pipeline given the
    tree directly; ``train`` (P14_CLI_EPOCHS); ``caption --keras-h5`` the
    lines of ``caption_images`` and ``score --keras-h5`` those of
    ``score_captions`` on the direct route (the same checkpoint step, the
    tree installed directly). -> (caption's launches, the checkpoint, the
    direct route's pipeline, P14_DECODED of the extracted rows)."""
    from tpucap_torch import ops
    from tpucap_torch.checkpoint import CheckpointManager
    from tpucap_torch.cli.main import _build_config, build_parser
    from tpucap_torch.convert import params_from_jax
    from tpucap_torch.data import load_descriptions, load_split, prepare_descriptions
    from tpucap_torch.pipeline import CaptioningPipeline
    from tpucap_torch.text import load_tokenizer
    from tpucap_torch.train import TrainState, build_optimizer

    ids = write_cli_dataset(root)
    paths = [root / "images" / f"{k}.jpg" for k in ids]
    feats_path, ckpt = root / "features.npz", root / "ckpt"
    cfg = _build_config(build_parser()[0].parse_args(["extract", *CLI_MODEL, "--images", "-", "--out", "-"]))
    ops.reset_launch_counts()
    out, err, extract_s, _ = run_cli(["extract", *CLI_MODEL, "--images", root / "images", "--out", feats_path,
                                      "--batch-size", CLI_EXTRACT_BATCH, "--keras-h5", h5])
    counts = ops.launch_counts()
    if [line for _, line in out] != [f"wrote {CLI_IMAGES} features to {feats_path}"] or any(counts.values()):
        raise AssertionError(f"keras extract: printed {out}, launches {counts}")
    with np.load(feats_path) as z:
        feats = {k: z[k] for k in z.files}
    direct = CaptioningPipeline(cfg, device=dev)
    direct.build()
    seed_encoder = direct.params["encoder"]
    direct.set_params({**direct.params, "encoder": params_from_jax(tree)})
    if torch.equal(seed_encoder["fc2"]["kernel"], direct.params["encoder"]["fc2"]["kernel"]):
        raise AssertionError("keras extract: the file's encoder is the config seed's")
    want, lib_s = timed(lambda: direct.extract_features(paths, batch_size=CLI_EXTRACT_BATCH))
    if sorted(feats) != sorted(ids) or not all(
        feats[k].dtype == np.float32 and np.array_equal(feats[k], w) for k, w in zip(ids, want)
    ) or not np.isfinite(want).all():
        raise AssertionError("keras extract: the rows differ from extract_features' on the tree given directly")
    log(f"keras extract --keras-h5: {CLI_IMAGES} rows of {want.shape[1]}, bit for bit extract_features' with the "
        f"tree installed directly; the command {extract_s:.5f} s (the 553 MB read and import included), "
        f"extract_features alone {lib_s:.5f} s; no kernel launched (the host preprocesses)")
    del seed_encoder

    out, _, train_s, _ = run_cli(["train", *CLI_MODEL, "--tokens", root / "tokens.txt", "--split",
                                  root / "train.txt", "--features", feats_path, "--checkpoint-dir", ckpt,
                                  "--epochs", P14_CLI_EPOCHS, "--batch-size", CLI_TRAIN_BATCH])
    if not out[-1][1].startswith(f"trained {P14_CLI_EPOCHS} epochs; "):
        raise AssertionError(f"keras train: printed {out}")
    tok = load_tokenizer(ckpt / "tokenizer.json")
    ref = CaptioningPipeline(cfg, tokenizer=tok, device=dev)
    ref.build(init_params=False)
    template = TrainState.create(tree_to(ref.decoder.init(torch.Generator()), dev),
                                 build_optimizer(cfg.train), torch.Generator(device=dev))
    mgr = CheckpointManager(ckpt, best_metric="val_loss")
    step = mgr.best_step()
    ref.set_params({"encoder": direct.params["encoder"], "decoder": mgr.restore(template, step).params})
    mgr.close()
    del direct

    picked = paths[:CLI_CAPTIONED]
    ops.reset_launch_counts()
    out, err, caption_s, _ = run_cli(["caption", *CLI_MODEL, "--image", *picked, "--checkpoint-dir", ckpt,
                                      "--keras-h5", h5])
    counts = ops.launch_counts()
    k2 = check_cli_counts("keras caption", counts, 1)
    caps = ref.caption_images(picked, method="beam", beam_width=BEAM)
    want = [f"{p}\t{c}" for p, c in zip(picked, caps)]
    if [line for _, line in out] != want or any("no --keras-h5" in line for line in err):
        raise AssertionError(f"keras caption: printed {out} {err}, the direct route gives {want}")
    log(f"keras caption --keras-h5: {CLI_CAPTIONED} images, beam {BEAM}, step {step} of {P14_CLI_EPOCHS} epoch "
        f"({train_s:.5f} s to train): the lines of caption_images with the tree installed directly; "
        f"{caption_s:.5f} s (the file's read included); launches {counts}: K1 {counts['preprocess_u8']}, "
        f"K2 {k2}, K3 {counts['merge_head']} + {counts['vocab_proj']}; e.g. {out[0][1]!r}")

    # A caption that is empty (an immediate endseq) is scored as a
    # reference caption of the training split instead.
    fallback = next(iter(prepare_descriptions(load_descriptions(root / "tokens.txt"),
                                              load_split(root / "train.txt")).values()))[0]
    caps = [c or fallback.removeprefix("startseq ").removesuffix(" endseq") for c in caps]
    (root / "captions.txt").write_text("".join(f"{c}\n" for c in caps))
    ops.reset_launch_counts()
    out, _, score_s, _ = run_cli(["score", *CLI_MODEL, "--image", *picked, "--captions-file",
                                  root / "captions.txt", "--checkpoint-dir", ckpt, "--keras-h5", h5])
    score_counts = ops.launch_counts()
    scores = ref.score_captions(ref.extract_features(picked), caps)
    want = [f"{p}\tlogp={s['logp']:.4f}\tppl={s['perplexity']:.3f}\ttokens={s['tokens']}\t{c}"
            for p, c, s in zip(picked, caps, scores)]
    if [line for _, line in out] != want:
        raise AssertionError(f"keras score: printed {out}, the direct route gives {want}")
    log(f"keras score --keras-h5: {CLI_CAPTIONED} images with their captions: the lines of score_captions with "
        f"the tree installed directly; {score_s:.5f} s; launches {score_counts}; e.g. {out[0][1]!r}")
    return counts, ckpt, ref, np.stack([feats[k] for k in ids[:P14_DECODED]])


def decode_tokens(pipe, feats, method: str):
    """``pipe``'s decode of ``feats`` -> (tokens, lengths) on the host and
    the launches."""
    from tpucap_torch import ops

    ops.reset_launch_counts()
    with torch.inference_mode():
        x = torch.as_tensor(feats).to(pipe.device, pipe._infer_dtype())
        res = pipe._decode(pipe._inference_params()["decoder"], x, method, 1 if method == "greedy" else BEAM)
    return (res.tokens.cpu(), res.lengths.cpu()), ops.launch_counts()


def reimport_decodes(label: str, pipe, imported, feats) -> dict[str, int]:
    """The decoder re-imported from its file against the one exported:
    params bit for bit, then greedy and beam tokens on ``feats`` token for
    token. -> the launches of the re-imported decodes."""
    from tpucap_torch.convert import params_from_jax, params_to_numpy

    if not same_numpy_tree(imported, params_to_numpy(pipe.params["decoder"])):
        raise AssertionError(f"{label}: the re-imported params differ from the exported ones")
    exported = pipe.params
    total = None
    report = []
    for method in ("greedy", "beam"):
        pipe.set_params(exported)
        want, want_counts = decode_tokens(pipe, feats, method)
        pipe.set_params({**exported, "decoder": params_from_jax(imported)})
        got, counts = decode_tokens(pipe, feats, method)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])) or counts != want_counts:
            raise AssertionError(f"{label} {method}: the re-imported decoder's tokens or launches differ")
        total = counts if total is None else {k: total[k] + counts[k] for k in counts}
        report.append(f"{method} K2 {counts['lstm_cell']} K3 {counts['merge_head']} + {counts['vocab_proj']}")
    pipe.set_params(exported)
    log(f"{label}: params bit for bit; greedy and beam {BEAM} of {len(feats)} rows token for token; launches "
        f"{', '.join(report)}")
    return total


def keras_exports(dev, tokenizer, root: Path, ckpt: Path, ref, feats: np.ndarray) -> dict[str, int]:
    """14(c): ``export`` of (a)'s trained CONFIG_1 merge decoder, then
    ``export_h5`` of CONFIG_2's inject decoder and of CONFIG_4's attention
    decoder (196 positions), each file re-imported; the merge decoder
    decodes ``feats`` (rows (a) extracted), the others seeded random
    features. -> the launches of the re-imported decodes."""
    from tpucap_torch.checkpoint import (
        KerasH5Model,
        attention_decoder_params_from_keras,
        export_h5,
        inject_decoder_params_from_keras,
        merge_decoder_params_from_keras,
    )

    path = root / "merge.h5"
    out, _, export_s, _ = run_cli(["export", *CLI_MODEL, "--checkpoint-dir", ckpt, "--out", path])
    if [line for _, line in out] != [f"wrote Keras h5 decoder to {path}"]:
        raise AssertionError(f"keras export: printed {out}")
    view, read_s = timed(lambda: KerasH5Model(path))
    log(f"keras export: CONFIG_1's lstm1 (vocab {ref.vocab_size}, max_len {ref.config.decode.max_len}): "
        f"{path.stat().st_size / 2**20:.2f} MiB, the command {export_s:.5f} s, read back {read_s:.5f} s")
    total = reimport_decodes("keras export merge", ref, merge_decoder_params_from_keras(view), feats)

    for preset, decoder, importer, kw in (
        ("config2", {"name": "inject"}, inject_decoder_params_from_keras, {}),
        ("config4", {}, attention_decoder_params_from_keras, None),
    ):
        pipe = preset_pipeline(preset, tokenizer, **decoder)
        if kw is None:
            kw = {"positions": pipe.encoder.spatial_positions}
        path = root / f"{preset}_{pipe.config.decoder.name}.h5"
        _, export_s = timed(lambda: export_h5(pipe.decoder, pipe.params["decoder"], path,
                                              max_len=pipe.config.decode.max_len, **kw))
        view, read_s = timed(lambda: KerasH5Model(path))
        n_layers = len(view.layers)
        g = np.random.default_rng(142)
        shape = (P14_DECODED, pipe.encoder.spatial_positions, pipe.config.encoder.feature_dim) \
            if kw else (P14_DECODED, pipe.config.encoder.feature_dim)
        x = g.normal(0, 1, shape).astype(np.float32)
        log(f"keras export_h5 {preset} {pipe.config.decoder.name} {kw}: {n_layers} layers, "
            f"{path.stat().st_size / 2**20:.2f} MiB written in {export_s:.5f} s, read back {read_s:.5f} s")
        counts = reimport_decodes(f"keras export {pipe.config.decoder.name}", pipe, importer(view), x)
        total = {k: total[k] + counts[k] for k in total}
        del pipe, view
    return total


def keras_encoders(dev, tokenizer, trees, paths) -> dict[str, int]:
    """14(b): ResNet-50's file into path A (BN folded, ``fused_blocks``)
    and InceptionV3's into CONFIG_2's encoder: the features and captions of
    the imported tree those of the tree installed directly, bit for bit.
    -> the counted path-A batch's launches."""
    from tpucap_torch import ops
    from tpucap_torch.checkpoint import params_from_keras
    from tpucap_torch.convert import params_from_jax
    from tpucap_torch.ops.preprocess import fused_preprocess

    g = torch.Generator(device=dev).manual_seed(14)
    total = None
    for arch in ("resnet50", "inception_v3"):
        if arch == "resnet50":
            pipe = make_pipeline("bf16", tokenizer)
        else:
            pipe = preset_pipeline("config2", tokenizer)
        enc = pipe.encoder
        images = torch.randint(0, 256, (BATCH, enc.input_size, enc.input_size, 3), generator=g, device=dev,
                               dtype=torch.uint8)
        results = {}
        for route, tree in (("imported", params_from_keras(paths[arch], arch)), ("direct", trees[arch])):
            pipe.set_params({**pipe.params, "encoder": params_from_jax(tree)})
            pipe.fold_bn()
            if arch == "resnet50":
                pipe.encoder = dataclasses.replace(enc, fused_blocks=True)
            with torch.inference_mode():
                x = fused_preprocess(images, enc.input_size, enc.preprocess_mode,
                                     out_dtype=pipe._infer_dtype())
                feats = pipe._apply_encoder(pipe._inference_params()["encoder"], x)
            caps = None
            if arch == "resnet50":
                ops.reset_launch_counts()
                caps, s = timed(lambda: pipe.caption_batch(images))
                counts = ops.launch_counts()
                if route == "imported":
                    steps = check_launches("keras path A", counts, {"preprocess_u8": 1, "identity_block": 12},
                                           decode=True)
                    total, imported_s = counts, s
            results[route] = (feats.float().cpu(), caps)
        (fa, ca), (fb, cb) = results["imported"], results["direct"]
        if not torch.equal(fa, fb) or ca != cb or not torch.isfinite(fa).all():
            raise AssertionError(f"keras {arch}: the imported encoder's features or captions differ")
        if arch == "resnet50":
            log(f"keras path A (resnet50 fused_blocks, bf16, beam {BEAM}): {BATCH} images, features and captions "
                f"of the imported tree those of the tree installed directly, bit for bit; caption_batch "
                f"{imported_s:.5f} s; launches {total} (K4 12, K2 {steps}); e.g. {ca[0]!r}")
        else:
            log(f"keras CONFIG_2 encode (inception_v3 at 299, K1 tf mode): {BATCH} images x {fa.shape[1]}, the "
                f"imported tree's features those of the tree installed directly, bit for bit")
        del pipe
    return total


def keras_finetune(dev, root: Path, tree, h5: Path) -> None:
    """14(d): ``train --finetune-encoder --keras-h5`` for one joint step
    (P14_FT_IDS training ids, batch CLI_TRAIN_BATCH), under torch's
    deterministic settings: its loss that of ``fit_finetune`` with the tree
    installed directly, bit for bit."""
    from tpucap_torch.cli.main import _build_config, build_parser
    from tpucap_torch.convert import params_from_jax
    from tpucap_torch.data import load_descriptions, load_split, prepare_descriptions
    from tpucap_torch.data.preprocess import preprocess_batch
    from tpucap_torch.pipeline import CaptioningPipeline

    train_ids = (root / "train.txt").read_text().split()[:P14_FT_IDS]
    (root / "ft_train.txt").write_text("".join(f"{k}\n" for k in train_ids))
    mlog = root / "ft.jsonl"
    argv = ["train", *CLI_MODEL, "--tokens", root / "tokens.txt", "--split", root / "ft_train.txt",
            "--finetune-encoder", "--images", root / "images", "--checkpoint-dir", root / "ft", "--epochs", 1,
            "--batch-size", CLI_TRAIN_BATCH, "--metrics-log", mlog]
    with deterministic_torch("keras fine-tune"):
        out, _, cli_s, _ = run_cli([*argv, "--keras-h5", h5])
        hist = [json.loads(line) for line in mlog.read_text().splitlines()]
        args = build_parser()[0].parse_args([str(a) for a in argv])
        pipe = CaptioningPipeline(_build_config(args), device=dev)
        prepared = prepare_descriptions(load_descriptions(root / "tokens.txt"), load_split(root / "ft_train.txt"))
        pipe.fit_tokenizer(prepared)
        pipe.build()
        pipe.set_params({**pipe.params, "encoder": params_from_jax(tree)})
        size, mode = pipe.encoder.input_size, pipe.encoder.preprocess_mode
        keys = list(prepared)
        images = dict(zip(keys, preprocess_batch([root / "images" / f"{k}.jpg" for k in keys], size=size,
                                                 mode=mode)))
        want, lib_s = timed(lambda: pipe.fit_finetune(prepared, images, epochs=1, batch_size=CLI_TRAIN_BATCH,
                                                      encoder_lr_scale=args.encoder_lr_scale))
    if len(hist) != 1 or hist[0]["loss"] != want[0]["loss"] or not np.isfinite(hist[0]["loss"]):
        raise AssertionError(f"keras fine-tune: the command's loss {hist} != fit_finetune's {want}")
    log(f"keras train --finetune-encoder --keras-h5 ({' '.join(CLI_MODEL)}, {P14_FT_IDS} ids x {CLI_REFS} "
        f"captions, batch {CLI_TRAIN_BATCH}): loss {hist[0]['loss']!r}, bit for bit fit_finetune's with the tree "
        f"installed directly; the command {cli_s:.5f} s, fit_finetune {lib_s:.5f} s; {out[-1][1]!r}")


def run_slice10(dev, tokenizer) -> dict[str, int]:
    """Phase 14. -> the counted runs' launches."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        trees, paths = write_keras_encoders(root)
        caption, ckpt, ref, feats = keras_cli(dev, root, trees["vgg16"], paths["vgg16"])
        exported = keras_exports(dev, tokenizer, root, ckpt, ref, feats)
        del ref
        path_a = keras_encoders(dev, tokenizer, trees, paths)
        keras_finetune(dev, root, trees["vgg16"], paths["vgg16"])
    return {k: caption[k] + path_a[k] + exported[k] for k in caption}


# -- phase 15: serving ---------------------------------------------------------

# The servers' batcher (tpucap serve's defaults), the closed-loop runs'
# client threads and seconds, the rows of (b), (d) and (e)'s batches, (e)'s
# repeats and (d)'s seconds of traffic on each side of the reload.
P15_MAX_BATCH, P15_DELAY_MS = 64, 5.0
P15_THREADS, P15_SECONDS, P15_JPEG_THREADS = (1, 16, 64), 5.0, 16
P15_ROWS, P15_F32_REPEATS, P15_RELOAD_SECONDS = 64, 20, 1.0
# The continuous engine (f)-(h): tpucap serve's ticks_per_sync, the threads
# that stream, and the gap between the staggered submissions of (f).
P15_TICKS, P15_STREAM_THREADS, P15_STAGGER_S = 8, 16, 0.002

# The closed-loop client, in a process of its own (the server's Python
# threads keep this process's interpreter lock): the port's CaptionClient
# only, standard library only. argv[1]: a JSON object of host, port, route
# ("features", "jpeg" or "stream": /caption_stream_features), model,
# threads, seconds, the path of a JSON list of feature rows or of JPEG
# file paths, and optionally "dials": [prefix, include_words] pairs that
# the feature requests take in turn (phase 16). Prints one JSON line: the answered count, the wall, each
# request's latency in ms (and, streaming, its first span's), the first
# errors. A stream whose spans do not join to its caption is an error.
P15_CLIENT = """
import json, sys, threading, time
sys.path.insert(0, sys.argv[2])
from tpucap_torch.client import CaptionClient

cfg = json.loads(sys.argv[1])
items = json.load(open(cfg["items"]))
dials = cfg.get("dials") or [["", []]]
if cfg["route"] == "jpeg":
    items = [open(p, "rb").read() for p in items]
client = CaptionClient(cfg["host"], cfg["port"], model=cfg["model"], timeout=120)
lat, first, errors, lock = [], [], [], threading.Lock()
start = time.perf_counter()
stop = start + cfg["seconds"]

def stream(item, t0):
    spans = []
    caption = client.caption_stream_features(
        item, lambda words: spans.append((time.perf_counter(), words)))
    if " ".join(w for _, ws in spans for w in ws) != caption:
        raise AssertionError(f"spans {spans} do not join to {caption!r}")
    with lock:
        first.append(((spans[0][0] if spans else time.perf_counter()) - t0) * 1e3)

def call(item, t0, i):
    if cfg["route"] == "stream":
        stream(item, t0)
    elif cfg["route"] == "jpeg":
        client.caption(item)
    else:
        prefix, words = dials[i % len(dials)]
        client.caption_features(item, prefix=prefix or None, include_words=words or None)

def worker(k):
    i = k
    while time.perf_counter() < stop:
        t0 = time.perf_counter()
        try:
            call(items[i % len(items)], t0, i)
        except Exception as e:
            with lock:
                errors.append(repr(e))
        else:
            with lock:
                lat.append((time.perf_counter() - t0) * 1e3)
        i += cfg["threads"]

threads = [threading.Thread(target=worker, args=(k,)) for k in range(cfg["threads"])]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"ok": len(lat), "wall": time.perf_counter() - start, "latencies_ms": lat,
                  "first_span_ms": first, "errors": errors[:5], "n_errors": len(errors)}))
"""


def percentile(sorted_ms: list, q: float) -> float:
    """Nearest rank, as the server's /stats takes its p50 and p99."""
    return sorted_ms[int(q * (len(sorted_ms) - 1))]


class LoadClient:
    """One closed-loop run of P15_CLIENT in its own process."""

    def __init__(self, addr, route: str, items_path: Path, threads: int, seconds: float,
                 model: str = "", dials=None):
        cfg = dict(host=addr[0], port=addr[1], route=route, model=model, threads=threads,
                   seconds=seconds, items=str(items_path), dials=dials)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", P15_CLIENT, json.dumps(cfg), str(ROOT)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )

    def result(self, label: str) -> dict:
        try:
            out, err = self.proc.communicate(timeout=120)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
        if self.proc.returncode != 0:
            raise AssertionError(f"{label}: client exited {self.proc.returncode}: {err[-2000:]}")
        res = json.loads(out.strip().splitlines()[-1])
        if res["n_errors"] or not res["ok"]:
            raise AssertionError(f"{label}: {res['n_errors']} requests failed ({res['errors']}), "
                                 f"{res['ok']} answered")
        return res


class BatchSizes:
    """The batch sizes (buckets) a pipeline's serving entry points are
    called with and the host seconds each dispatch took (the decode syncs
    every few steps, so nearly the whole decode), wrapped on the instance
    for phase 15's histograms. Beside them, since the last ``start()``, the
    work those calls gave the kernels: images batches (one encoder pass
    each, K4's 12 launches) and the steps of their decodes (one launch each
    of K2 and K3's two kernels). A step counts only inside a wrapped call,
    so a decode made anywhere else adds nothing."""

    def __init__(self, *pipes):
        self.calls: list[tuple[int, float]] = []
        self.images = self.steps = 0
        self._lock = threading.Lock()
        self._inside = threading.local()
        for pipe in pipes:
            for name in ("generate_submit", "encode_submit"):
                setattr(pipe, name, self._wrap(getattr(pipe, name), name == "encode_submit"))
            pipe.step_fn = self._wrap_step_fn(pipe.step_fn)

    def _wrap(self, fn, images: bool):
        def counted(x, **kw):
            t0 = time.perf_counter()
            self._inside.on = True
            try:
                out = fn(x, **kw)
            finally:
                self._inside.on = False
            self.calls.append((len(x), time.perf_counter() - t0))
            with self._lock:
                self.images += images
            return out
        return counted

    def _wrap_step_fn(self, step_fn):
        def counted_step_fn():
            step = step_fn()

            def counted_step(*a, **kw):
                if getattr(self._inside, "on", False):
                    with self._lock:
                        self.steps += 1
                return step(*a, **kw)
            return counted_step
        return counted_step_fn

    def start(self) -> None:
        with self._lock:
            self.images = self.steps = 0

    def take(self) -> tuple[dict[int, int], float]:
        """-> (the buckets' histogram, mean ms a dispatch) since the last take."""
        calls, self.calls = self.calls, []
        sizes = [b for b, _ in calls]
        mean_ms = 1e3 * sum(t for _, t in calls) / len(calls) if calls else 0.0
        return {b: sizes.count(b) for b in sorted(set(sizes))}, mean_ms


class FlagProbe:
    """Reads the TF32 flags inside a pipeline's device work: at the start
    and end of its encoder's apply (cuDNN's convolutions) and at every step
    of its decodes (the step runs right after init_state, the decode's
    cuBLAS call). -> how many reads found another setting than the
    pipeline's precision asks for."""

    def __init__(self, pipe):
        self.tf32 = pipe.config.precision != "f32"
        self.reads = self.wrong = 0
        encoder, apply = pipe.encoder, pipe.encoder.apply

        def probed_apply(*a, **kw):
            self.read()
            out = apply(*a, **kw)
            self.read()
            return out

        object.__setattr__(encoder, "apply", probed_apply)  # the encoder is frozen
        step_fn = pipe.step_fn

        def probed_step_fn():
            step = step_fn()

            def probed_step(*a, **kw):
                self.read()
                return step(*a, **kw)
            return probed_step

        pipe.step_fn = probed_step_fn

    def read(self) -> None:
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        self.reads += 1
        self.wrong += flags != (self.tf32, self.tf32)

    def take(self) -> tuple[int, int]:
        out = (self.reads, self.wrong)
        self.reads = self.wrong = 0
        return out


def served_pipeline(precision: str, tokenizer, seed: int = 0):
    """Path A (BN folded, fused identity blocks) at phase 3's widths."""
    pipe = make_pipeline(precision, tokenizer, seed=seed)
    pipe.encoder = dataclasses.replace(pipe.encoder, fused_blocks=True)
    return pipe


def offline_jpeg(pipe, blob: bytes, method=None) -> str:
    """The offline route of one JPEG at bucket 1: the port's host decode,
    preprocess_input, encode_images, generate."""
    from tpucap_torch.serve_http import _preprocess_jpeg

    x = _preprocess_jpeg(blob, pipe.encoder.input_size, pipe.encoder.preprocess_mode)
    return pipe.generate(pipe.encode_images(x[None]), method=method)[0]


def closed_loop(srv, client_addr, sizes: BatchSizes, label: str, route: str, items: Path,
                threads: int, model: str = "", endpoint: str = "features") -> dict:
    """One closed-loop run: captions/s, client p50 / p99, the server's mean
    batch and the buckets of this run's batches."""
    name = "default" if not model else model
    server = srv._models[name][2 if endpoint == "features" else 1]
    before = server.stats()
    sizes.take()
    res = LoadClient(client_addr, route, items, threads, P15_SECONDS, model).result(label)
    after = server.stats()
    lat = sorted(res["latencies_ms"])
    batches = after["batches"] - before["batches"]
    buckets, dispatch_ms = sizes.take()
    row = {
        "captions_per_s": res["ok"] / res["wall"],
        "p50_ms": percentile(lat, 0.5), "p99_ms": percentile(lat, 0.99),
        "mean_batch": (after["requests"] - before["requests"]) / max(1, batches),
        "buckets": buckets, "dispatch_ms": dispatch_ms, "answered": res["ok"],
    }
    log(f"serve {label}: {threads} client threads, {res['ok']} answered in {res['wall']:.3f} s: "
        f"captions/s {row['captions_per_s']:.2f}; client p50 {row['p50_ms']:.3f} ms, "
        f"p99 {row['p99_ms']:.3f} ms; server mean batch {row['mean_batch']:.2f}; "
        f"buckets {row['buckets']}; {dispatch_ms:.3f} ms a dispatch")
    return row


def reload_seed(tokenizer, rows, old: list[str]) -> tuple[object, list[str], int]:
    """The first seed after 0 whose f32 pipeline changes every one of
    ``old``, the seed-0 captions of ``rows``. -> (that pipeline, its
    captions, seed)."""
    for seed in range(1, 6):
        other = served_pipeline("f32", tokenizer, seed=seed)
        new = other.generate(rows)
        if all(a != b for a, b in zip(old, new)):
            return other, new, seed
        del other
    raise AssertionError("no seed in 1-5 changes every row's caption")


def reload_under_load(srv, addr, rows, old: list[str], new: list[str], bundle: Path,
                      model: str = "f32", label: str = "reload under load") -> dict:
    """(d), (h): one client sends /caption_batch of ``rows`` to ``model`` in
    a loop; /reload swaps in ``bundle`` meanwhile. Every reply must be the
    old captions or the new, whole; every request sent after /reload
    answered must get the new."""
    from tpucap_torch.client import CaptionClient

    client = CaptionClient(*addr, model=model, timeout=120)
    replies, stop = [], threading.Event()
    body = rows.tolist()

    def loop():
        while not stop.is_set():
            t0 = time.perf_counter()
            caps = client.caption_features_many(body)
            replies.append((t0, caps))

    t = threading.Thread(target=loop)
    t.start()
    time.sleep(P15_RELOAD_SECONDS)
    t_call = time.perf_counter()
    answer = CaptionClient(*addr, timeout=600).reload(str(bundle), model=model or None)
    t_done = time.perf_counter()
    time.sleep(P15_RELOAD_SECONDS)
    stop.set()
    t.join(timeout=120)
    if t.is_alive() or answer != {"ok": True, "bundle": str(bundle)}:
        raise AssertionError(f"{label}: answer {answer}, client alive {t.is_alive()}")
    kinds = []
    for t0, caps in replies:
        kind = "old" if caps == old else "new" if caps == new else "mixed"
        if kind == "mixed" or (t0 >= t_done and kind != "new"):
            rows_old = sum(c == o for c, o in zip(caps, old))
            rows_new = sum(c == n for c, n in zip(caps, new))
            raise AssertionError(f"{label}: a reply sent {t0 - t_done:+.4f} s after the "
                                 f"reload answered is {kind} ({rows_old} rows old, {rows_new} new "
                                 f"of {len(caps)})")
        kinds.append(kind)
    if "old" not in kinds or "new" not in kinds:
        raise AssertionError(f"{label}: replies {kinds}")
    row = {"replies": len(kinds), "old": kinds.count("old"), "new": kinds.count("new"),
           "reload_s": t_done - t_call}
    log(f"serve {label}: /reload answered in {row['reload_s']:.4f} s; {row['replies']} "
        f"replies of {len(rows)} rows, {row['old']} all old weights, {row['new']} all new, none "
        "mixed; every request sent after the answer got the new weights")
    return row


def two_precisions(srv, addr, items: Path, f32_body: tuple, want: tuple, probe: FlagProbe) -> int:
    """(e): the bf16 model under load from 16 threads (features and JPEGs)
    while model f32's /caption_batch of feature rows and of JPEGs run
    P15_F32_REPEATS times. Every f32 reply must be (b)'s, and every read of
    the TF32 flags inside model f32's device work must find them off. (The
    replies alone can hardly show a wrong flag: make_pipeline shrinks the
    image branch, so a TF32 rounding of the features seldom moves a token.)
    -> the bf16 model's answered count."""
    from tpucap_torch.client import CaptionClient

    client = CaptionClient(*addr, model="f32", timeout=120)
    loads = [LoadClient(addr, "features", items[0], P15_JPEG_THREADS // 2, P15_SECONDS),
             LoadClient(addr, "jpeg", items[1], P15_JPEG_THREADS // 2, P15_SECONDS)]
    time.sleep(1.0)  # the load is running
    probe.take()
    bad = 0
    for _ in range(P15_F32_REPEATS):
        bad += client.caption_features_many(f32_body[0]) != want[0]
        bad += client.caption_jpegs_many(f32_body[1]) != want[1]
    reads, wrong = probe.take()
    answered = sum(load.result("two precisions: bf16 load")["ok"] for load in loads)
    log(f"serve two precisions: {2 * P15_F32_REPEATS} f32 replies (features and JPEG batches of "
        f"{P15_ROWS}) under {answered} bf16 requests from {P15_JPEG_THREADS} threads: "
        f"{2 * P15_F32_REPEATS - bad} equal to (b)'s, {bad} differ; {reads} reads of the TF32 "
        f"flags inside model f32's encodes and decode steps, {wrong} found TF32 on")
    if bad or wrong:
        raise AssertionError(f"two precisions: {bad} f32 replies differ from (b)'s, {wrong} of "
                             f"{reads} flag reads inside model f32's work found TF32 on")
    return answered


class AdmissionWaves:
    """Counts the admission waves of continuous images servers (one encoder
    pass each, K4's 12 launches): ``_admission_arrays`` wrapped on the
    instance."""

    def __init__(self, servers):
        self.waves = 0
        for server in servers:
            arrays = server._admission_arrays

            def counted(ids, payloads, arrays=arrays):
                self.waves += 1
                return arrays(ids, payloads)

            server._admission_arrays = counted


def continuous_servers(conts) -> list:
    """Every ContinuousCaptionServer behind the continuous HTTP servers."""
    return [server for http in conts.values() for _, im, fe in http._models.values() for server in (im, fe)]


def staggered(call, items, gap: float) -> list:
    """``call`` on each item from a thread of its own, started ``gap`` s
    apart. -> the results in order."""
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        time.sleep(gap * i)
        return call(items[i])

    with ThreadPoolExecutor(len(items)) as pool:
        return list(pool.map(one, range(len(items))))


def logit_gaps(pipe, feats, got: list[str], want: list[str]) -> list[str]:
    """For each caption that differs from its reference: the position of the
    first differing word and the plain f32 logit gap there between the two
    words (endseq where one caption ended), teacher-forced on the common
    prefix, on the pipeline's params."""
    from tpucap_torch.core import precision_flags

    wi = pipe.tokenizer.word_index
    start, end = pipe._token_ids()
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        wa, wb = a.split() + ["endseq"], b.split() + ["endseq"]
        p = next(k for k in range(min(len(wa), len(wb))) if wa[k] != wb[k])
        prefix = [start] + [wi[w] for w in wa[:p]]
        with torch.inference_mode(), precision_flags("f32"):
            logits = pipe.decoder.forward_train(
                pipe.params["decoder"], torch.as_tensor(feats[i:i + 1]).to(pipe.device).float(),
                torch.tensor([prefix], device=pipe.device), deterministic=True)[0, -1]
        gap = float(logits[wi.get(wa[p], end)] - logits[wi.get(wb[p], end)])
        out.append(f"row {i} word {p}: served {wa[p]!r}, reference {wb[p]!r}, logit gap {gap:+.3e}")
    return out


def continuous_exactness(conts, f32, rows, x, blobs, want: dict) -> None:
    """(f): the f32 model's 64 feature rows and 64 JPEGs behind the
    continuous engine, greedy and beam BEAM, in one /caption_batch each and
    as staggered single requests: token for token generate's and the
    offline route's."""
    from tpucap_torch.client import CaptionClient

    for method in ("greedy", "beam"):
        client = CaptionClient(*conts[f"f32 {method}"].address, timeout=120)
        runs = {
            "features batch": (client.caption_features_many(rows), want[method][0], rows),
            "jpeg batch": (client.caption_jpegs_many(blobs), want[method][1], None),
            "features staggered": (staggered(client.caption_features, list(rows), P15_STAGGER_S),
                                   want[method][0], rows),
            "jpeg staggered": (staggered(client.caption, blobs, P15_STAGGER_S), want[method][1], None),
        }
        for label, (got, ref, feats) in runs.items():
            if got != ref:
                why = logit_gaps(f32, feats, got, ref) if feats is not None else [
                    f"row {i}" for i, (a, b) in enumerate(zip(got, ref)) if a != b]
                raise AssertionError(f"continuous exactness, {method} {label}: {len(why)} of "
                                     f"{len(ref)} captions differ from the offline route: {why[:8]}")
        log(f"serve continuous exactness ({method}): f32 /caption_batch of {P15_ROWS} rows and of "
            f"{P15_ROWS} JPEGs, and each as {P15_ROWS} single requests {P15_STAGGER_S * 1e3:.0f} ms "
            "apart, token for token generate's and the offline route's")


def continuous_loop(http, addr, label: str, route: str, items: Path, threads: int) -> dict:
    """(g): one closed-loop run on the continuous engine: captions/s,
    client p50 / p99 (and the first span's, streaming), the features
    server's ticks, sync groups, mean occupancy and ms a sync group (the
    run's wall over its sync groups)."""
    server = http._features
    before = dict(server.stats(), occ=server._tick_occupancy)
    res = LoadClient(addr, route, items, threads, P15_SECONDS).result(label)
    after = dict(server.stats(), occ=server._tick_occupancy)
    lat = sorted(res["latencies_ms"])
    ticks = after["ticks"] - before["ticks"]
    groups = after["batches"] - before["batches"]
    row = {
        "captions_per_s": res["ok"] / res["wall"], "p50_ms": percentile(lat, 0.5),
        "p99_ms": percentile(lat, 0.99), "ticks": ticks, "groups": groups,
        "mean_occupancy": (after["occ"] - before["occ"]) / max(1, ticks),
        "ms_a_group": 1e3 * res["wall"] / max(1, groups), "answered": res["ok"],
    }
    first = sorted(res["first_span_ms"])
    extra = ""
    if first:
        row["first_p50_ms"], row["first_p99_ms"] = percentile(first, 0.5), percentile(first, 0.99)
        extra = (f"; first span p50 {row['first_p50_ms']:.3f} ms, p99 {row['first_p99_ms']:.3f} ms, "
                 "every stream's spans joined to its caption")
    log(f"serve {label}: {threads} client threads, {res['ok']} answered in {res['wall']:.3f} s: "
        f"captions/s {row['captions_per_s']:.2f}; client p50 {row['p50_ms']:.3f} ms, p99 "
        f"{row['p99_ms']:.3f} ms{extra}; {ticks} ticks in {groups} sync groups, mean occupancy "
        f"{row['mean_occupancy']:.2f} of {P15_MAX_BATCH}, {row['ms_a_group']:.3f} ms a sync group")
    return row


def caption_lengths(captions: list[str]) -> str:
    """The served captions' word counts: min / median / max."""
    n = sorted(len(c.split()) for c in captions)
    return f"{n[0]} / {n[len(n) // 2]} / {n[-1]} words"


def run_continuous(conts, f32, rows, x, blobs, want: dict, items: tuple, reload: tuple) -> dict[str, int]:
    """Phase 15 (f)-(h) on the continuous engine, inside a launch window of
    its own: every launch must be a served tick's (K2 and K3's two kernels
    once each) or a served images admission wave's (K4 12 times). ->
    the window's launches."""
    from tpucap_torch import ops

    servers = continuous_servers(conts)
    waves = AdmissionWaves([s for s in servers if s._mode == "images"])
    ticks0 = sum(s._tick_count for s in servers)
    ops.reset_launch_counts()
    continuous_exactness(conts, f32, rows, x, blobs, want)
    log(f"serve continuous: the f32 captions' lengths, greedy {caption_lengths(want['greedy'][0])}, "
        f"beam {caption_lengths(want['beam'][0])} (max_len {MAX_LEN})")
    bf16 = conts["bf16 beam"]
    addr = bf16.address
    for n in P15_THREADS:
        continuous_loop(bf16, addr, f"continuous features x{n}", "features", items[0], n)
    continuous_loop(bf16, addr, f"continuous stream x{P15_STREAM_THREADS}", "stream", items[0],
                    P15_STREAM_THREADS)
    bundle, new = reload
    reload_under_load(conts["f32 beam"], conts["f32 beam"].address, rows, want["beam"][0], new,
                      bundle, model="", label="continuous reload under load")
    counts = ops.launch_counts()
    ticks = sum(s._tick_count for s in servers) - ticks0
    served = {"lstm_cell": ticks, "merge_head": ticks, "vocab_proj": ticks,
              "identity_block": 12 * waves.waves}
    expect = {name: served.get(name, 0) for name in counts}
    log(f"serve continuous: launches over (f)-(h) {counts}; the continuous servers ran {ticks} "
        f"ticks and {waves.waves} images admission waves")
    if counts != expect or not ticks or not waves.waves:
        raise AssertionError(f"serve continuous: launches {counts}, the served ticks and waves "
                             f"ask for {expect}")
    return counts


def run_serving(dev, tokenizer) -> dict[str, int]:
    """Phase 15. -> the counted runs' launches ((b)-(e), (f)-(h))."""
    import tempfile

    from tpucap_torch import ops
    from tpucap_torch.client import CaptionClient
    from tpucap_torch.serve_http import CaptionHTTPServer, _preprocess_jpeg_batch

    del dev
    bf16 = served_pipeline("bf16", tokenizer)
    f32 = served_pipeline("f32", tokenizer)
    sizes = BatchSizes(bf16, f32)
    probe = FlagProbe(f32)
    srv = CaptionHTTPServer(bf16, host="127.0.0.1", port=0, max_batch=P15_MAX_BATCH,
                            max_delay_ms=P15_DELAY_MS, allow_reload=True, extra_models={"f32": f32})
    addr = srv.serve_background()
    log(f"serve: path A (resnet50 fused_blocks + lstm1, vocab {VOCAB}, beam {BEAM}, max_len "
        f"{MAX_LEN}) bf16 as the default model and f32 as model f32 on http://{addr[0]}:{addr[1]}, "
        f"max_batch {P15_MAX_BATCH}, max_delay_ms {P15_DELAY_MS}, buckets {srv._features._buckets}")
    # The continuous engine (f)-(h): one server a model and method (it
    # serves no extra model). Built now, their engines keep the params of
    # now: (d)'s reload of the f32 pipeline leaves their lanes as they are.
    cont_kw = dict(host="127.0.0.1", port=0, max_batch=P15_MAX_BATCH, ticks_per_sync=P15_TICKS,
                   engine="continuous", allow_reload=True)
    conts = {
        "f32 greedy": CaptionHTTPServer(f32, method="greedy", **cont_kw),
        "f32 beam": CaptionHTTPServer(f32, method="beam", beam_width=BEAM, **cont_kw),
        "bf16 beam": CaptionHTTPServer(bf16, method="beam", beam_width=BEAM, **cont_kw),
    }
    for http in conts.values():
        http.serve_background()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            # (a) warmup: every bucket of each server.
            for name, (_, images, features) in sorted(srv._models.items()):
                for endpoint, server in (("images", images), ("features", features)):
                    t0 = time.perf_counter()
                    server.warmup()
                    log(f"serve warmup {name}/{endpoint}: buckets 1-{P15_MAX_BATCH} in "
                        f"{time.perf_counter() - t0:.3f} s")
            for name, http in conts.items():
                for endpoint, server in (("images", http._images), ("features", http._features)):
                    t0 = time.perf_counter()
                    server.warmup()
                    log(f"serve warmup continuous {name}/{endpoint}: buckets 1-{P15_MAX_BATCH}, "
                        f"{P15_TICKS} ticks each, in {time.perf_counter() - t0:.3f} s")
            sizes.take()

            g = np.random.default_rng(15)
            rows = g.normal(size=(P15_ROWS, DEC_FEATURES)).astype(np.float32)
            feature_items = tmp / "rows.json"
            feature_items.write_text(json.dumps(g.normal(size=(256, DEC_FEATURES)).astype(np.float32).tolist()))
            paths = [FIXTURES / f for f in BASELINE_FIXTURES]
            jpeg_items = tmp / "jpegs.json"
            jpeg_items.write_text(json.dumps([str(p) for p in paths]))
            blobs = [p.read_bytes() for p in paths]
            batch_blobs = [blobs[i % len(blobs)] for i in range(P15_ROWS)]

            # Every offline reference, the ceiling and the reload's bundle
            # first: the launch window below holds served requests only.
            x = _preprocess_jpeg_batch(batch_blobs, f32.encoder.input_size, f32.encoder.preprocess_mode)
            want = (f32.generate(rows), f32.generate(f32.encode_images(x)))
            cont_want = {"beam": want, "greedy": (
                f32.generate(rows, method="greedy"),
                f32.generate(f32.encode_images(x), method="greedy"))}
            want_single = [offline_jpeg(bf16, blob) for blob in blobs]
            offline = min(timed(lambda: bf16.generate(rows))[1] for _ in range(3))
            ceiling = P15_ROWS / offline
            other, new, seed = reload_seed(tokenizer, rows, want[0])
            bundle = tmp / f"seed{seed}"
            other.save(bundle)
            del other
            log(f"serve ceiling: offline generate of {P15_ROWS} rows (bf16) {offline * 1e3:.3f} ms, "
                f"{ceiling:.2f} captions/s; reload seed {seed} changes every row's caption")

            sizes.take()
            sizes.start()
            ops.reset_launch_counts()
            # (b) exactness: the f32 model's /caption_batch of feature rows and
            # of JPEGs against the offline route at 64; each fixture's
            # /caption of the default model against the offline route at 1.
            client = CaptionClient(*addr, timeout=120)
            f32_rows = client.caption_features_many(rows, model="f32")
            if f32_rows != want[0]:
                raise AssertionError("exactness: f32 /caption_batch != generate of the same rows")
            f32_jpegs = client.caption_jpegs_many(batch_blobs, model="f32")
            if f32_jpegs != want[1]:
                raise AssertionError("exactness: f32 /caption_batch of JPEGs != the offline route")
            for path, blob, cap in zip(paths, blobs, want_single):
                if client.caption(blob) != cap:
                    raise AssertionError(f"exactness: /caption of {path.name} != the offline route")
            log(f"serve exactness: f32 /caption_batch of {P15_ROWS} rows and of {P15_ROWS} JPEGs "
                f"token for token generate's and the offline route's; /caption of the "
                f"{len(paths)} baseline fixtures (bf16) each the offline route's at bucket 1")

            # (c) closed-loop load.
            sizes.take()
            for n in P15_THREADS:
                closed_loop(srv, addr, sizes, f"features x{n}", "features", feature_items, n)
            most = P15_THREADS[-1]
            srv._features._depth = 2  # the batcher reads it once a batch
            closed_loop(srv, addr, sizes, f"features x{most} depth 2", "features", feature_items, most)
            srv._features._depth = 1
            closed_loop(srv, addr, sizes, f"jpeg x{P15_JPEG_THREADS}", "jpeg", jpeg_items,
                        P15_JPEG_THREADS, endpoint="images")

            # (e) two precisions in one process, then (d) reload (of model f32).
            two_precisions(srv, addr, (feature_items, jpeg_items), (rows, batch_blobs), want, probe)
            reload_under_load(srv, addr, rows, want[0], new, bundle)
            counts = ops.launch_counts()
            served = {"lstm_cell": sizes.steps, "merge_head": sizes.steps,
                      "vocab_proj": sizes.steps, "identity_block": 12 * sizes.images}
            log(f"serve: launches over (b)-(e) {counts}; the served batches made "
                f"{sizes.images} encoder passes and {sizes.steps} decode steps")
            expect = {name: served.get(name, 0) for name in counts}
            if counts != expect or not sizes.images or not sizes.steps:
                raise AssertionError(f"serve: launches {counts}, the served batches' work asks "
                                     f"for {expect}")
            # (f)-(h), the continuous engine, in a launch window of its own.
            cont = run_continuous(conts, f32, rows, x, batch_blobs, cont_want,
                                  (feature_items, jpeg_items), (bundle, new))
            counts = {name: counts[name] + cont[name] for name in counts}
    finally:
        srv.close()
        for http in conts.values():
            http.close()
    return counts


# -- phase 16: the per-request dials -------------------------------------------

# The dialled batch at the batch server's largest bucket (path A at bench.py's
# defaults: lstm1, vocab 7579, max_len 34, beam 3, f32), the prefixes' word
# counts a row in turn (P padded to 8), the constraint counts C, and the rows
# of K2 and K3's steps that phase 2 checks for it and phase 15: 64 while
# priming (and the continuous engine's greedy lanes), B·k = 192 while
# continuing, B·2^C·k = 384, 768 and 3072 constrained.
P16_ROWS, P16_PREFIX_WORDS, P16_CONSTRAINTS = 64, (0, 1, 3, 5), (1, 2, 4)
P16_STEP_ROWS = (P16_ROWS, P16_ROWS * BEAM) + tuple(P16_ROWS * BEAM * (1 << c) for c in (1, 2, 4))
# The normalized score of a kernel-path detail against the plain path's:
# f32 sums of up to 34 log-probs, each logit within ROUTE_ATOL + ROUTE_RTOL
# |x| of the plain step's (phase 9), divided by the length.
P16_SCORE_ATOL = 1e-4


class DialWork:
    """The kernel work of phase 16, wrapped on the pipeline instance: every
    call of the step its ``step_fn`` makes (on the card the fused step: one
    launch each of K2 and K3's two kernels), the priming steps among them,
    and every encoder pass (``_apply_encoder``: K4's 12 launches with
    ``fused_blocks``). A plain path installs its own ``step_fn`` and is not
    counted."""

    def __init__(self, pipe):
        import tpucap_torch.pipeline as pipeline_mod

        self.steps = self.priming = self.encodes = 0
        self.prime_s: list[float] = []
        self._lock = threading.Lock()
        self._mod, self._prime = pipeline_mod, pipeline_mod.prime_prefix
        step_fn, apply = pipe.step_fn, pipe._apply_encoder

        def counted_step_fn():
            step = step_fn()

            def counted(*a, **kw):
                with self._lock:
                    self.steps += 1
                return step(*a, **kw)
            return counted

        def counted_apply(*a, **kw):
            with self._lock:
                self.encodes += 1
            return apply(*a, **kw)

        def primed(step, *a, **kw):
            def counted(*sa, **skw):
                with self._lock:
                    self.priming += 1
                return step(*sa, **skw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._prime(counted, *a, **kw)
            torch.cuda.synchronize()
            self.prime_s.append(time.perf_counter() - t0)
            return out

        pipe.step_fn, pipe._apply_encoder = counted_step_fn, counted_apply
        pipeline_mod.prime_prefix = primed

    def close(self) -> None:
        self._mod.prime_prefix = self._prime

    def snapshot(self) -> tuple[int, int, int]:
        return self.steps, self.priming, self.encodes


def plain_path(pipe, fn):
    """``fn()`` with the pipeline's decodes on the plain step (the card's
    cuBLAS, no kernel)."""
    counted = pipe.step_fn
    pipe.step_fn = lambda: pipe.decoder.step
    try:
        return fn()
    finally:
        pipe.step_fn = counted


def vocab_words(tokenizer) -> list[str]:
    return [w for w in tokenizer.word_index if w not in ("startseq", "endseq")]


def p16_prefixes(tokenizer, n: int, seed: int) -> list[str]:
    """n prefixes of P16_PREFIX_WORDS words in turn, vocabulary words drawn
    from ``seed``."""
    rng, words = np.random.default_rng(seed), vocab_words(tokenizer)
    return [" ".join(str(w) for w in rng.choice(words, P16_PREFIX_WORDS[i % len(P16_PREFIX_WORDS)],
                                                  replace=False)) for i in range(n)]


def p16_words(tokenizer, n: int, c: int, seed: int) -> list[list[str]]:
    """n rows of c distinct vocabulary words drawn from ``seed``."""
    rng, words = np.random.default_rng(seed), vocab_words(tokenizer)
    return [[str(w) for w in rng.choice(words, c, replace=False)] for _ in range(n)]


def same_or_gaps(label: str, pipe, feats, got: list[str], want: list[str]) -> None:
    """Token for token, or a fault naming each differing row's logit gap."""
    if got != want:
        why = logit_gaps(pipe, feats, got, want)
        raise AssertionError(f"{label}: {len(why)} of {len(want)} captions differ from the plain "
                             f"step path: {why[:8]}")


def dial_continuation(pipe, work: DialWork, feats, tokenizer) -> None:
    """16(a): ``generate_continuation`` greedy and beam BEAM on P16_ROWS rows
    with prefixes of 0, 1, 3 and 5 words in turn: the kernel path against
    the plain step path token for token, P priming steps a call, the empty
    prefix ``generate``'s; ms a call and the priming's ms (medians of 3
    calls after the checked one, which pays the allocator's first growth
    for the new shapes)."""
    prefixes = p16_prefixes(tokenizer, P16_ROWS, seed=16)
    P = 1 << (max(P16_PREFIX_WORDS) - 1).bit_length()
    for method in ("greedy", "beam"):
        call = lambda: pipe.generate_continuation(feats, prefixes, method=method)  # noqa: E731
        s0, p0, _ = work.snapshot()
        got = call()
        steps, priming = work.steps - s0, work.priming - p0
        if priming != P or steps <= P:
            raise AssertionError(f"continuation {method}: {priming} priming steps of {steps}, want {P}")
        same_or_gaps(f"continuation {method}", pipe, feats, got, plain_path(pipe, call))
        for pre, cap in zip(prefixes, got):
            if not cap.startswith(pre):
                raise AssertionError(f"continuation {method}: {cap!r} does not open with {pre!r}")
        empty = pipe.generate_continuation(feats, "", method=method)
        if empty != pipe.generate(feats, method=method):
            raise AssertionError(f"continuation {method}: the empty prefix != generate")
        work.prime_s.clear()
        ms = float(np.median([timed(call)[1] for _ in range(3)])) * 1e3
        prime_ms = float(np.median(work.prime_s)) * 1e3
        log(f"dials continuation {method}: f32, {P16_ROWS} rows, prefixes of {P16_PREFIX_WORDS} words "
            f"(P {P}): {P} priming and {steps - P} decode steps; token for token the plain step "
            f"path's; the empty prefix generate's; {ms:.3f} ms a call, priming "
            f"{prime_ms:.3f} ms; lengths {caption_lengths(got)}")


def dial_constrained(pipe, work: DialWork, feats, tokenizer) -> None:
    """16(b): ``generate_constrained`` at C = 1, 2 and 4 (every row its own
    words): the kernel path against the plain path, captions and satisfied
    words exact, scores within P16_SCORE_ATOL; the satisfaction rate; ms a
    decode and a step beside unconstrained beam BEAM (medians of 3 calls
    after the checked one)."""
    s0 = work.steps
    pipe.generate(feats, method="beam")
    base_steps = work.steps - s0
    base_s = float(np.median([timed(lambda: pipe.generate(feats, method="beam"))[1] for _ in range(3)]))
    log(f"dials constrained: unconstrained beam {BEAM}, {P16_ROWS * BEAM} rows a step: "
        f"{base_s * 1e3:.3f} ms a decode, {base_steps} steps, {base_s * 1e3 / base_steps:.3f} ms a step")
    for c in P16_CONSTRAINTS:
        words = p16_words(tokenizer, P16_ROWS, c, seed=160 + c)
        call = lambda: pipe.generate_constrained(feats, words, return_details=True)  # noqa: E731
        s0 = work.steps
        got = call()
        steps = work.steps - s0
        want = plain_path(pipe, call)
        same_or_gaps(f"constrained C={c}", pipe, feats, [d["caption"] for d in got],
                     [d["caption"] for d in want])
        err = 0.0
        for g, w, row in zip(got, want, words):
            if (g["satisfied"], g["num_satisfied"]) != (w["satisfied"], w["num_satisfied"]):
                raise AssertionError(f"constrained C={c}: {g} != the plain path's {w}")
            err = max(err, abs(g["score"] - w["score"]))
            held = set(g["caption"].split())
            if sorted(g["satisfied"]) != sorted(row) or any(ok != (wd in held) for wd, ok in g["satisfied"].items()):
                raise AssertionError(f"constrained C={c}: satisfied {g['satisfied']} for {g['caption']!r}")
        if err > P16_SCORE_ATOL:
            raise AssertionError(f"constrained C={c}: scores {err:.3g} from the plain path's")
        rate = sum(d["num_satisfied"] for d in got) / (c * P16_ROWS)
        sec = float(np.median([timed(call)[1] for _ in range(3)]))
        log(f"dials constrained C={c}: {P16_ROWS * BEAM << c} rows a step; captions and satisfied "
            f"words the plain path's, scores within {err:.3g}; satisfaction rate {rate:.4f}; "
            f"{sec * 1e3:.3f} ms a decode, {steps} steps, {sec * 1e3 / steps:.3f} ms a "
            f"step ({sec * base_steps / (steps * base_s):.2f}x beam {BEAM}'s); lengths "
            f"{caption_lengths([d['caption'] for d in got])}")


def dial_serving(pipe, feats, tokenizer, tmp: Path) -> None:
    """16(c), (d): the f32 model behind ``CaptionHTTPServer`` (batch engine,
    beam BEAM): one /caption_batch of P16_ROWS rows, a third plain, a third
    prefixed, a third constrained (C = 2), each reply the offline call's on
    the same rows; each baseline fixture's ``/caption?prefix=`` and
    ``?include_words=`` (images mode, K4) the offline route's at bucket 1;
    then a closed loop of 16 clients with a third of the requests prefixed
    and a third constrained beside the plain loop."""
    from tpucap_torch.client import CaptionClient
    from tpucap_torch.serve_http import CaptionHTTPServer, _preprocess_jpeg

    prefixes = p16_prefixes(tokenizer, P16_ROWS, seed=17)
    words = p16_words(tokenizer, P16_ROWS, 2, seed=17)
    kind = [i % 3 for i in range(P16_ROWS)]  # 0 plain, 1 prefixed, 2 constrained
    rows = np.asarray(feats.cpu(), np.float32)
    row_prefix = [prefixes[i] if kind[i] == 1 else "" for i in range(P16_ROWS)]
    row_words = [words[i] if kind[i] == 2 else [] for i in range(P16_ROWS)]
    other = [i for i in range(P16_ROWS) if kind[i] != 2]
    cons = [i for i in range(P16_ROWS) if kind[i] == 2]
    want = [None] * P16_ROWS
    for i, cap in zip(other, pipe.generate_continuation(rows[other], [row_prefix[i] for i in other])):
        want[i] = cap
    for i, cap in zip(cons, pipe.generate_constrained(rows[cons], [row_words[i] for i in cons])):
        want[i] = cap
    paths = [FIXTURES / f for f in BASELINE_FIXTURES]
    blobs = [p.read_bytes() for p in paths]
    jpeg_dials = [(prefixes[3], None) if i % 2 else (None, words[i]) for i in range(len(blobs))]
    jpeg_want = []
    for blob, (pre, w) in zip(blobs, jpeg_dials):
        x = pipe.encode_images(_preprocess_jpeg(blob, pipe.encoder.input_size, pipe.encoder.preprocess_mode)[None])
        jpeg_want.append(pipe.generate_continuation(x, pre)[0] if pre else pipe.generate_constrained(x, w)[0])
    items = tmp / "p16_rows.json"
    g = np.random.default_rng(16)
    items.write_text(json.dumps(g.normal(size=(256, DEC_FEATURES)).astype(np.float32).tolist()))
    mix = [["", []], [prefixes[3], []], ["", words[0]]]

    http = CaptionHTTPServer(pipe, host="127.0.0.1", port=0, max_batch=P15_MAX_BATCH,
                             max_delay_ms=P15_DELAY_MS)
    addr = http.serve_background()
    try:
        client = CaptionClient(*addr, timeout=120)
        got = client.caption_features_many(rows, prefixes=row_prefix, include_words_rows=row_words)
        if got != want:
            bad = [i for i in range(P16_ROWS) if got[i] != want[i]]
            raise AssertionError(f"dials server: rows {bad} differ from the offline calls "
                                 f"(kinds {[kind[i] for i in bad]})")
        for path, blob, (pre, w), cap in zip(paths, blobs, jpeg_dials, jpeg_want):
            if client.caption(blob, prefix=pre, include_words=w) != cap:
                raise AssertionError(f"dials server: /caption of {path.name} with {pre or w} != the "
                                     "offline route")
        log(f"dials server: f32 /caption_batch of {P16_ROWS} rows ({kind.count(0)} plain, "
            f"{kind.count(1)} prefixed, {kind.count(2)} constrained at C = 2) token for token the "
            f"offline calls'; /caption of the {len(paths)} baseline fixtures, prefixed or "
            "constrained, each the offline route's at bucket 1")
        loops = {}
        for label, dials in (("plain", None), ("dialled", mix)):
            res = LoadClient(addr, "features", items, P15_JPEG_THREADS, P15_SECONDS,
                             dials=dials).result(f"dials loop {label}")
            lat = sorted(res["latencies_ms"])
            loops[label] = res["ok"] / res["wall"]
            log(f"dials loop {label}: {P15_JPEG_THREADS} client threads, {res['ok']} answered in "
                f"{res['wall']:.3f} s: captions/s {loops[label]:.2f}; client p50 "
                f"{percentile(lat, 0.5):.3f} ms, p99 {percentile(lat, 0.99):.3f} ms"
                + ("" if dials is None else "; a third prefixed, a third constrained at C = 2"))
        log(f"dials loop: the dialled mix at {loops['dialled'] / loops['plain']:.3f}x the plain "
            "loop's captions/s")
    finally:
        http.close()


def run_dials(dev, tokenizer) -> dict[str, int]:
    """Phase 16, one launch window: every K2 and K3 launch a counted step
    (priming and decode, offline and served), K4 12 a counted encoder pass,
    nothing else. -> the window's launches."""
    import tempfile

    from tpucap_torch import ops

    pipe = served_pipeline("f32", tokenizer)
    work = DialWork(pipe)
    g = torch.Generator(device=dev).manual_seed(16)
    feats = torch.randn((P16_ROWS, DEC_FEATURES), generator=g, device=dev)
    log(f"dials: path A (resnet50 fused_blocks + lstm1, vocab {VOCAB}, beam {BEAM}, max_len {MAX_LEN}) "
        f"f32, {P16_ROWS} rows of {DEC_FEATURES}-d features")
    ops.reset_launch_counts()
    try:
        with torch.inference_mode():
            dial_continuation(pipe, work, feats, tokenizer)
            dial_constrained(pipe, work, feats, tokenizer)
        with tempfile.TemporaryDirectory() as tmp:
            dial_serving(pipe, feats, tokenizer, Path(tmp))
        counts = ops.launch_counts()
    finally:
        work.close()
    served = {"lstm_cell": work.steps, "merge_head": work.steps, "vocab_proj": work.steps,
              "identity_block": 12 * work.encodes}
    expect = {name: served.get(name, 0) for name in counts}
    log(f"dials: launches over phase 16 {counts}; {work.steps} counted steps "
        f"({work.priming} of them priming, the plain paths' included), {work.encodes} encoder passes")
    if counts != expect or not work.steps or not work.encodes:
        raise AssertionError(f"dials: launches {counts}, the counted work asks for {expect}")
    return counts


# -- phase 17: the tools and the sampler ---------------------------------------

# Path A's 64 rows (the batch server's largest bucket) in f32 and bf16; the
# first-token test's rows and its head bias (a random decoder's first-step
# distribution is flat, 7579 words at about 1/7579 each: the bias, drawn with
# std P17_BIAS_STD, puts 19-67 expected draws in each of the 16 likeliest
# words' bins); the chi-square bound: 16 degrees of freedom (16 bins and the
# pooled rest), p = 1e-4 (scipy.stats.chi2.ppf(1 - 1e-4, 16)).
P17_ROWS, P17_DRAW_ROWS, P17_BINS, P17_BIAS_STD = 64, 4096, 16, 2.0
P17_CHI2_BOUND = 45.92
P17_TOP_P = 0.9
# The kernels of a bf16 decode step as the profiler names them.
P17_DECODE_KERNELS = ("lstm_cell_kernel", "merge_head_kernel", "vocab_proj_kernel")


def sample_result(pipe, feats, step, *, generator=None, draws=None, params=None, max_len=None, **dials):
    """``sample_decode`` of ``feats`` on the pipeline's decoder with ``step``
    under its flags -> DecodeResult."""
    from tpucap_torch.core import precision_flags
    from tpucap_torch.decode import sample_decode

    params = pipe._inference_params()["decoder"] if params is None else params
    start, end = pipe._token_ids()
    feats = feats.to(pipe._infer_dtype())
    with torch.inference_mode(), precision_flags(pipe.config.precision):
        return sample_decode(step, params, pipe.decoder.init_state(params, feats), generator=generator,
                             draws=draws, start_id=start, end_id=end,
                             max_len=max_len or pipe.config.decode.max_len, **dials)


def sample_route(pipe, work, feats, label: str) -> None:
    """17 (b) and, in f32, (a) and (c): one seed twice gives the same bits;
    top_k = 1 is greedy token for token (in bf16 the logits tie at the top,
    and every tied word stays in the draw, as in tpucap); the kernel path on
    a set of draws equals the plain step path on the same draws, a row that
    differs reported with the gap between its two words' perturbed logits (a
    fault unless within the f32 route's logit tolerance)."""
    dev = feats.device
    f32 = pipe.config.precision == "f32"
    if f32 and pipe.generate(feats, method="sample", top_k=1, temperature=0.7, seed=3) != pipe.generate(
            feats, method="greedy"):
        raise AssertionError(f"tools {label}: sampling at top_k = 1 != greedy")
    one = [sample_result(pipe, feats, pipe.step_fn(), top_p=P17_TOP_P,
                         generator=torch.Generator(device=dev).manual_seed(11)) for _ in range(2)]
    for a, b in ((one[0].tokens, one[1].tokens), (one[0].lengths, one[1].lengths),
                 (one[0].scores, one[1].scores)):
        if not torch.equal(a, b):
            raise AssertionError(f"tools {label}: one seed gave two results")
    msg = (f"tools {label}: {P17_ROWS} rows, " + ("sampling at top_k = 1 greedy's captions; " if f32 else "")
           + f"one seed twice the same tokens, lengths and score bits (top_p {P17_TOP_P})")
    if f32:
        g = torch.Generator(device=dev).manual_seed(12)
        from tpucap_torch.decode.sample import gumbel_noise

        draws = [gumbel_noise((P17_ROWS, VOCAB), generator=g, device=dev) for _ in range(MAX_LEN)]
        fused = sample_result(pipe, feats, pipe.step_fn(), draws=draws)
        seen = []

        def recording(p, st, tok):
            logits, st = pipe.decoder.step(p, st, tok)
            seen.append(logits.float())
            return logits, st

        plain = sample_result(pipe, feats, recording, draws=draws)
        differ = (fused.tokens != plain.tokens).any(dim=1).nonzero().flatten().tolist()
        gaps = []
        for r in differ:
            t = int((fused.tokens[r] != plain.tokens[r]).nonzero()[0])
            a, b = int(fused.tokens[r, t]), int(plain.tokens[r, t])
            z = seen[t][r] + draws[t][r]
            # Each logit within the f32 route's tolerance of the plain one.
            tol = 2 * (ROUTE_ATOL + ROUTE_RTOL * float(seen[t][r][[a, b]].abs().max()))
            gaps.append((r, t, float(z[b] - z[a]), tol))
        log(f"tools f32: kernel path against the plain step path on the same draws: "
            f"{P17_ROWS - len(differ)} of {P17_ROWS} rows token for token; differing rows "
            f"(row, step, perturbed logit gap) {gaps}; scores within "
            f"{float((fused.scores - plain.scores).abs().max()):.3g}")
        if any(abs(gap) > tol for _, _, gap, tol in gaps):
            raise AssertionError(f"tools f32: kernel path and plain path differ beyond a near-tie: {gaps}")
    log(msg)


def first_token_frequencies(pipe, work) -> None:
    """17 (d): P17_DRAW_ROWS rows of one feature row, one sampling step at
    temperature 1 with no truncation, the head's bias drawn with std
    P17_BIAS_STD: the first token's counts in the P17_BINS likeliest words'
    bins and the pooled rest against the plain f32 step's softmax (pad
    excluded), chi-square within P17_CHI2_BOUND."""
    from tpucap_torch.core import precision_flags, tree_map

    dev = pipe.device
    params = tree_map(lambda t: t, pipe._inference_params()["decoder"])
    params["out"] = dict(params["out"])
    g = torch.Generator(device=dev).manual_seed(17)
    bias = torch.randn(params["out"]["bias"].shape, generator=g, device=dev) * P17_BIAS_STD
    params["out"]["bias"] = bias.to(params["out"]["bias"].dtype)
    feats = torch.randn((1, DEC_FEATURES), generator=g, device=dev).expand(P17_DRAW_ROWS, -1).contiguous()
    s0 = work.steps
    res = sample_result(pipe, feats, pipe.step_fn(), params=params, max_len=1,
                        generator=torch.Generator(device=dev).manual_seed(18))
    if work.steps - s0 != 1:
        raise AssertionError(f"tools: the first-token draw took {work.steps - s0} steps")
    start, _ = pipe._token_ids()
    with torch.inference_mode(), precision_flags("f32"):
        state = pipe.decoder.init_state(params, feats[:1])
        logits = pipe.decoder.step(params, state, torch.tensor([start], device=dev))[0][0].float()
        probs = torch.softmax(logits.index_fill(0, torch.tensor([0], device=dev), -torch.inf), -1).double()
    order = torch.argsort(probs, descending=True)[:P17_BINS]
    counts = torch.bincount(res.tokens[:, 0], minlength=VOCAB).double()
    observed = torch.cat([counts[order], (P17_DRAW_ROWS - counts[order].sum()).reshape(1)])
    expected = torch.cat([probs[order], (1 - probs[order].sum()).reshape(1)]) * P17_DRAW_ROWS
    chi2 = float(((observed - expected) ** 2 / expected).sum())
    log(f"tools: first token of {P17_DRAW_ROWS} draws at temperature 1: expected "
        f"{[round(x, 1) for x in expected[:P17_BINS].tolist()]} (rest {expected[-1]:.1f}), observed "
        f"{[int(x) for x in observed.tolist()]}; chi-square {chi2:.3f} on {P17_BINS} degrees of "
        f"freedom, bound {P17_CHI2_BOUND} (p = 1e-4)")
    if not chi2 <= P17_CHI2_BOUND:
        raise AssertionError(f"tools: first-token chi-square {chi2:.3f} > {P17_CHI2_BOUND}")


def n_best_and_server(pipe, feats) -> None:
    """17 (e), (f): ``generate_n_best`` entry 0 is ``generate(beam)`` at
    beam BEAM; a sampling server in images mode gives ``generate(method=
    "sample")`` of the same batch's features."""
    from tpucap_torch.serve import CaptionServer

    best = pipe.generate_n_best(feats)
    if [row[0][0] for row in best] != pipe.generate(feats, method="beam"):
        raise AssertionError("tools: generate_n_best's entry 0 != generate(beam)")
    if any(len(row) != BEAM or [s for _, s in row] != sorted((s for _, s in row), reverse=True)
           for row in best):
        raise AssertionError("tools: an n-best list is not beam-wide and best first")
    g = torch.Generator(device=pipe.device).manual_seed(19)
    images = torch.rand((P17_ROWS, IMAGE, IMAGE, 3), generator=g, device=pipe.device).cpu().numpy()
    with CaptionServer(pipe, mode="images", max_batch=P17_ROWS, max_delay_ms=2000, method="sample") as srv:
        got = [f.result(120) for f in srv.submit_many(images)]
    want = pipe.generate(pipe.encode_images(images), method="sample")
    if got != want:
        raise AssertionError(f"tools: the sampling server's {sum(a != b for a, b in zip(got, want))} "
                             "captions differ from generate(method='sample')")
    log(f"tools: generate_n_best entry 0 generate(beam)'s at beam {BEAM}, {P17_ROWS} rows; a sampling "
        f"server in images mode ({P17_ROWS} images, one batch) generate(method='sample')'s captions")


def sampling_times(pipe, work, feats, smi: str) -> None:
    """17 (j): ms a decode step of sampling against greedy's, with and
    without top-p (median of 3 calls after a warm one)."""
    rows = []
    for label, kw in (("greedy", dict(method="greedy")), ("sample", dict(method="sample")),
                      (f"sample top_p {P17_TOP_P}", dict(method="sample", top_p=P17_TOP_P))):
        call = lambda: pipe.generate(feats, **kw)  # noqa: E731
        s0 = work.steps
        call()
        steps = work.steps - s0
        ms = float(np.median([timed(call)[1] for _ in range(3)])) * 1e3
        rows.append(f"{label} {ms / steps:.4f} ms a step ({steps} steps, {ms:.3f} ms)")
    log(f"tools: {pipe.config.precision}, {P17_ROWS} rows: " + "; ".join(rows) + f" [{smi}]")


def cli_subprocesses(tmp: Path) -> None:
    """17 (g): ``python -m tpucap_torch doctor`` and ``profile --workload
    decode|train|encoder`` (and ``--encoder vit_b16``) as subprocesses side
    by side, the decode trace holding K2's and K3's kernels, the ViT route
    logged."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    profiles = {
        "decode": ["--workload", "decode", "--encoder", "resnet50"],
        "train": ["--workload", "train", "--encoder", "resnet50", "--train-precision", "bf16"],
        "encoder": ["--workload", "encoder", "--encoder", "resnet50"],
        "encoder vit_b16": ["--workload", "encoder", "--encoder", "vit_b16"],
    }
    procs = {"doctor": subprocess.Popen([sys.executable, "-m", "tpucap_torch", "doctor"], cwd=ROOT, env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for name, argv in profiles.items():
        out = tmp / name.replace(" ", "_")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "tpucap_torch", "profile", *argv, "--steps", "3", "--out", str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            if proc.returncode:
                raise AssertionError(f"tools: {name} exited {proc.returncode}: {err[-2000:]}")
            done[name] = (out, err)
    finally:
        for proc in procs.values():
            proc.kill()
    report = json.loads(done["doctor"][0])
    if report.get("platform") != "gpu" or not report.get("matmul_ok") or not isinstance(report.get("kernels"), list):
        raise AssertionError(f"tools: doctor reported {report}")
    log(f"tools: doctor: {json.dumps(report)}")
    for name in profiles:
        (trace,) = (tmp / name.replace(" ", "_")).glob("*.pt.trace.json")
        events = json.loads(trace.read_text())["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        # The host's ranges; on the card each also shows as a
        # gpu_user_annotation span.
        steps = sum(1 for e in events if e.get("name") == "profile_step" and e.get("cat") == "user_annotation")
        found = {k: sum(k in n for n in kernels) for k in P17_DECODE_KERNELS}
        if steps != 3 or not kernels or (name == "decode" and not all(found.values())):
            raise AssertionError(f"tools: profile {name}: {steps} profile_step ranges, kernels {found}")
        route = [ln for ln in done[name][1].splitlines() if "attention_impl" in ln]
        log(f"tools: profile {name}: {trace.stat().st_size} bytes, {steps} profile_step ranges, "
            f"{len(kernels)} kernel events" + (f", K2 / K3 {found}" if name == "decode" else "")
            + (f"; {route[0]}" if route else ""))


def train_tensorboard(tmp: Path) -> None:
    """17 (h): ``train --tensorboard-dir`` (with ``--metrics-log``) on phase
    8's dataset and random 4096-d features, its event file read back with
    ``read_scalars`` as the logged records."""
    from tpucap_torch.utils import read_scalars

    root = tmp / "cli"
    root.mkdir()
    ids = write_cli_dataset(root)
    rng = np.random.default_rng(17)
    np.savez(root / "features.npz", **{k: rng.normal(size=4096).astype(np.float32) for k in ids})
    tb, metrics = root / "tb", root / "metrics.jsonl"
    _, err, sec, _ = run_cli(["train", *CLI_MODEL, "--tokens", root / "tokens.txt", "--split", root / "train.txt",
                              "--features", root / "features.npz", "--checkpoint-dir", root / "ckpt",
                              "--epochs", 2, "--batch-size", CLI_TRAIN_BATCH, "--metrics-log", metrics,
                              "--tensorboard-dir", tb])
    history = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    want = [(k, h["epoch"], float(np.float32(v))) for h in history for k, v in h.items()
            if k not in ("epoch", "step", "wall_time") and isinstance(v, (int, float))]
    got = read_scalars(tb)
    if got != want or not got:
        raise AssertionError(f"tools: train --tensorboard-dir read back {got[:6]}, logged {want[:6]}")
    log(f"tools: train {' '.join(CLI_MODEL)} --tensorboard-dir on phase 8's dataset ({CLI_SPLITS[0]} ids, 2 "
        f"epochs, {sec:.2f} s): {len(got)} scalars read back, the logged records'")


def run_tools(dev, tokenizer, smi: str) -> dict[str, int]:
    """Phase 17, one launch window over (a)-(f) and (j): K2 and K3's kernels
    once a counted step, K4 12 times a counted encoder pass, nothing else
    (the profile subprocesses count in their own processes). -> its
    launches."""
    import tempfile

    from tpucap_torch import ops

    pipes = {p: served_pipeline(p, tokenizer) for p in ("f32", "bf16")}
    works = {p: DialWork(pipe) for p, pipe in pipes.items()}
    g = torch.Generator(device=dev).manual_seed(170)
    feats = torch.randn((P17_ROWS, DEC_FEATURES), generator=g, device=dev)
    log(f"tools: path A (resnet50 fused_blocks + lstm1, vocab {VOCAB}, beam {BEAM}, max_len {MAX_LEN}), "
        f"{P17_ROWS} rows of {DEC_FEATURES}-d features")
    ops.reset_launch_counts()
    try:
        for p, pipe in pipes.items():
            sample_route(pipe, works[p], feats, p)
        first_token_frequencies(pipes["f32"], works["f32"])
        n_best_and_server(pipes["bf16"], feats.bfloat16())
        sampling_times(pipes["bf16"], works["bf16"], feats.bfloat16(), smi)
        counts = ops.launch_counts()
    finally:
        for work in reversed(list(works.values())):
            work.close()
    steps = sum(w.steps for w in works.values())
    encodes = sum(w.encodes for w in works.values())
    expect = {name: {"lstm_cell": steps, "merge_head": steps, "vocab_proj": steps,
                     "identity_block": 12 * encodes}.get(name, 0) for name in counts}
    log(f"tools: launches over phase 17 {counts}; {steps} counted steps, {encodes} encoder passes")
    if counts != expect or not steps or not encodes:
        raise AssertionError(f"tools: launches {counts}, the counted work asks for {expect}")
    del pipes, works
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cli_subprocesses(Path(tmp))
        train_tensorboard(Path(tmp))
    return counts


# -- phase 18: the rest of the decode toolkit ----------------------------------

# Path A's 64 rows (the batch server's largest bucket) in f32, timed in bf16;
# the diverse search's groups and penalty (G groups of BEAM beams: 576 rows a
# step at 64 images), the MBR pools' size (the beam pool's width
# max(P18_POOL, BEAM): 320 rows; the diverse pool P18_POOL groups of BEAM: 960
# rows), the rows of K2 and K3's steps that phase 2 checks for it.
P18_ROWS, P18_GROUPS, P18_DIVERSITY, P18_POOL = 64, 3, 0.5, 5
P18_STEP_ROWS = (P18_ROWS * max(P18_POOL, BEAM), P18_ROWS * P18_GROUPS * BEAM, P18_ROWS * P18_POOL * BEAM)
# Teacher-forced attention maps against the decode's own, and a map's sum.
P18_ALPHA_ATOL = 1e-5


def toolkit_encode(pipe, images) -> torch.Tensor:
    """uint8 images -> the pipeline's features: K1, then its encoder (on
    path A K4's 12 launches)."""
    from tpucap_torch.ops.preprocess import fused_preprocess

    enc = pipe.encoder
    with torch.inference_mode():
        x = fused_preprocess(images, enc.input_size, enc.preprocess_mode, out_dtype=pipe._infer_dtype())
        return pipe._apply_encoder(pipe._inference_params()["encoder"], x)


def same_captions(label: str, got: list[str], want: list[str], pipe=None, feats=None) -> int:
    """Token for token, but for at most an eighth of the rows parted at a
    near-tie: with random weights every row opens with the same words, and a
    last-bit difference (a log-softmax, a row's logsumexp at another
    alignment, the kernel route's logits) may part a row where two words
    tie. Parted rows are logged, with the plain f32 logit gap at the first
    differing word where ``pipe`` decodes both; more fail. -> their count."""
    rows = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if rows:
        why = logit_gaps(pipe, feats, got, want) if pipe is not None else [
            f"row {i}: {got[i]!r} against {want[i]!r}" for i in rows]
        log(f"{label}: {len(rows)} of {len(want)} rows parted at a near-tie: {why[:8]}")
    if len(rows) > len(want) // 8:
        raise AssertionError(f"{label}: {len(rows)} of {len(want)} rows differ: rows {rows[:8]}")
    return len(rows)


def toolkit_diverse(a, work, feats) -> None:
    """18 (a), (b): diverse search at G = 1 is beam BEAM (captions and
    scores); at diversity 0 every group is beam BEAM's but for rows parted
    at a near-tie (at most an eighth); at G = P18_GROUPS,
    k' = BEAM, P18_DIVERSITY the kernel path against the plain step path,
    group by group."""
    from tpucap_torch.core import precision_flags
    from tpucap_torch.decode.beam import _tile_state

    beam = [row[0] for row in a.generate_n_best(feats, n=1)]
    one = a.generate_diverse(feats, num_groups=1, group_width=BEAM)
    same_captions("diverse G = 1 against beam", [row[0][0] for row in one], [c for c, _ in beam])
    if any(abs(row[0][1] - s) > 0 for row, (_, s) in zip(one, beam)):
        raise AssertionError("diverse G = 1: normalized scores differ from beam's")
    # At diversity 0 every group is beam BEAM in exact arithmetic. Rows of
    # 7579 f32 logits start at every 4-byte offset mod 16, and the card's
    # row reductions (logsumexp) round in an order that follows a row's
    # alignment: identical hypotheses in another row of the step may part at
    # a near-tie. Counted, with the normalized scores' gap, and probed below.
    zero = a.generate_diverse(feats, num_groups=P18_GROUPS, group_width=BEAM, diversity=0.0)
    parted = {g: [(i, row[g][1] - s) for i, (row, (c, s)) in enumerate(zip(zero, beam)) if row[g][0] != c]
              for g in range(P18_GROUPS)}
    if any(len(p) > P18_ROWS // 8 for p in parted.values()):
        raise AssertionError(f"diverse diversity 0: rows apart from beam {BEAM}: {parted}")
    params = a._inference_params()["decoder"]
    start, _ = a._token_ids()
    K = P18_GROUPS * BEAM
    with torch.inference_mode(), precision_flags(a.config.precision):
        state = a.decoder.init_state(params, feats)
        probe = {}
        for k in (BEAM, K):
            logits, _ = a.step_fn()(params, _tile_state(state, k), torch.full(
                (P18_ROWS * k,), start, dtype=torch.long, device=feats.device))
            probe[k] = (logits, torch.logsumexp(logits.float(), dim=-1))
    # The same hypothesis at row b*K (group 0) and b*K + BEAM (group 1) of one
    # step, and at row b*BEAM of beam's step.
    same = {name: (torch.equal(t[::K], t[BEAM::K]), torch.equal(t[::K], probe[BEAM][j][::BEAM]))
            for j, (name, t) in enumerate((("logits", probe[K][0]), ("logsumexp", probe[K][1])))}
    call = lambda: a.generate_diverse(  # noqa: E731
        feats, num_groups=P18_GROUPS, group_width=BEAM, diversity=P18_DIVERSITY)
    s0 = work.steps
    got = call()
    steps = work.steps - s0
    want = plain_path(a, call)
    for g in range(P18_GROUPS):
        same_or_gaps(f"diverse group {g}", a, feats, [row[g][0] for row in got], [row[g][0] for row in want])
    err = max(abs(x[1] - y[1]) for r, q in zip(got, want) for x, y in zip(r, q))
    if not err <= P16_SCORE_ATOL:
        raise AssertionError(f"diverse: normalized scores {err:.3g} from the plain path's")
    differ = sum(row[0][0] != row[1][0] for row in got)
    distinct = sum(len({c for c, _ in row}) for row in got) / len(got)
    log(f"toolkit diverse: f32, {P18_ROWS} rows: G = 1 beam {BEAM}'s captions and scores; diversity 0: "
        f"rows apart from beam {BEAM} by group (row, normalized score gap) {parted}; one step, the same "
        f"hypothesis in group 0 and group 1 of {P18_ROWS * K} rows, and in beam's {P18_ROWS * BEAM} rows, "
        f"bit for bit: {same}; G {P18_GROUPS} x k' "
        f"{BEAM} ({P18_ROWS * P18_GROUPS * BEAM} rows a step, {steps} "
        f"steps), diversity {P18_DIVERSITY}: token for token the plain step path's, normalized scores "
        f"within {err:.3g}; group 0 and group 1 differ in {differ} of {P18_ROWS} rows, {distinct:.2f} "
        f"distinct captions a row")


def toolkit_ensemble(a, b, att, feats, pooled, grids) -> None:
    """18 (c)-(e), each ``same_captions``: a singleton ensemble against
    ``generate``; two lstm1 members (seeds 0 and 1) on the kernel path
    against the plain step path, one-hot weights against member 0's
    ``generate``; path A's lstm1 with CONFIG_4's
    attention decoder, each on its own encoder's features of one image
    batch (``pooled``, ``grids``), against the plain step path (the
    attention member's step is plain either way)."""
    both_plain = lambda fn: plain_path(a, lambda: plain_path(b, fn))  # noqa: E731
    for method in ("greedy", "beam"):
        want = a.generate(feats, method=method)
        single = same_captions(f"ensemble singleton {method}", a.generate_ensemble(feats, [], method=method),
                               want, a, feats)
        pair = lambda: a.generate_ensemble(feats, [b], method=method)  # noqa: E731
        got = pair()
        paired = same_captions(f"ensemble pair {method}", got, both_plain(pair))
        hot = same_captions(f"ensemble one-hot {method}",
                            a.generate_ensemble(feats, [b], method=method, weights=[1.0, 0.0]), want, a, feats)
        mixed = lambda: a.generate_ensemble([pooled, grids], [att], method=method)  # noqa: E731
        het = mixed()
        hetero = same_captions(f"ensemble lstm1 + attention {method}", het, plain_path(a, mixed))
        log(f"toolkit ensemble {method}: f32, {P18_ROWS} rows, rows parted at a near-tie from the reference: "
            f"the singleton against generate {single}; seeds 0 + 1 against the plain step path {paired} "
            f"({sum(x != y for x, y in zip(got, want))} rows differ from member 0 alone); weights [1, 0] "
            f"against member 0's generate {hot}; lstm1 (pooled) + attention ({tuple(grids.shape[1:])} grid) "
            f"against the plain path {hetero}, {len(set(het))} distinct captions")


def toolkit_mbr(a, feats) -> None:
    """18 (f): ``generate_mbr`` from each source: every pick in its pool and
    ``mbr_select``'s pick of the returned pools."""
    from tpucap_torch.decode import mbr_select

    for source in ("sample", "beam", "diverse"):
        caps, pools = a.generate_mbr(feats, n_candidates=P18_POOL, candidates=source, return_candidates=True)
        picks, utils = mbr_select(pools)
        if len(pools) != P18_ROWS or any(len(p) != P18_POOL for p in pools) or caps != [
                p[i] for p, i in zip(pools, picks)] or any(c not in p for c, p in zip(caps, pools)):
            raise AssertionError(f"mbr {source}: picks {caps[:3]} of pools {pools[:1]}")
        log(f"toolkit mbr {source}: {P18_ROWS} pools of {P18_POOL}: each pick in its pool and mbr_select's; "
            f"{sum(len(set(p)) for p in pools) / P18_ROWS:.2f} distinct candidates a pool, mean utility "
            f"{float(np.mean(utils)):.4f}")


def toolkit_attention(att, grids) -> None:
    """18 (g): ``generate_with_attention`` greedy on CONFIG_4 (f32): its
    teacher-forced maps against those that a step-by-step replay of the
    decode's tokens records through ``_step_full``, for t < length; every
    such map sums to 1."""
    from tpucap_torch.core import precision_flags

    caps, alphas, lengths = att.generate_with_attention(grids, method="greedy")
    if caps != att.generate(grids, method="greedy"):
        raise AssertionError("attention maps: captions != generate(greedy)")
    params = att._inference_params()["decoder"]
    start, _ = att._token_ids()
    dec = att.decoder
    with torch.inference_mode(), precision_flags("f32"):
        tokens = att._decode(params, grids, "greedy", BEAM).tokens
        state = dec.init_state(params, grids)
        last = torch.full((len(grids),), start, dtype=torch.long, device=grids.device)
        replay = []
        for t in range(int(lengths.max())):
            _, state, alpha = dec._step_full(params, state, last)
            replay.append(alpha.float().cpu().numpy())
            last = tokens[:, t]
    replay = np.stack(replay, axis=1)
    live = np.arange(replay.shape[1])[None, :] < lengths[:, None]
    err = float(np.abs(alphas[:, : replay.shape[1]] - replay)[live].max())
    sums = float(np.abs(alphas[:, : replay.shape[1]].sum(-1) - 1.0)[live].max())
    if alphas.shape != (len(grids), MAX_LEN, grids.shape[1]) or not (err <= P18_ALPHA_ATOL and sums <= P18_ALPHA_ATOL):
        raise AssertionError(f"attention maps {alphas.shape}: replay within {err:.3g}, sums within {sums:.3g}")
    log(f"toolkit attention maps: CONFIG_4 f32, {len(grids)} images, {grids.shape[1]} cells: alphas "
        f"{alphas.shape}, within {err:.3g} of the decode's replay and summing to 1 within {sums:.3g} over "
        f"{int(live.sum())} live steps; lengths {caption_lengths(caps)}")


def toolkit_times(a, b, work, feats, smi: str) -> None:
    """18 (j): bf16 at P18_ROWS rows: ms a step of diverse search (G
    P18_GROUPS x k' BEAM) against beam search of the same rows, of a
    two-member ensemble against one model, and one ``generate_mbr`` call a
    source (medians of 3 calls after a warm one)."""
    fb = feats.bfloat16()
    rows = []

    def per_step(label, call):
        s0 = work.steps  # member 0's steps: one an engine step
        call()
        steps = work.steps - s0
        ms = float(np.median([timed(call)[1] for _ in range(3)])) * 1e3
        rows.append(f"{label} {ms / steps:.4f} ms a step ({steps} steps, {ms:.3f} ms)")

    G = P18_GROUPS
    per_step(f"diverse {G} x {BEAM}", lambda: a.generate_diverse(fb, num_groups=G, group_width=BEAM))
    per_step(f"beam {G * BEAM}", lambda: a.generate(fb, method="beam", beam_width=G * BEAM))
    per_step("ensemble of 2 greedy", lambda: a.generate_ensemble(fb, [b], method="greedy"))
    per_step("greedy", lambda: a.generate(fb, method="greedy"))
    for source in ("sample", "beam", "diverse"):
        call = lambda: a.generate_mbr(fb, n_candidates=P18_POOL, candidates=source)  # noqa: E731
        call()
        ms = float(np.median([timed(call)[1] for _ in range(3)])) * 1e3
        rows.append(f"mbr {source} ({P18_POOL} candidates) {ms:.3f} ms a call")
    log(f"toolkit times: bf16, {P18_ROWS} rows: " + "; ".join(rows) + f" [{smi}]")


def toolkit_cli(dev, cli_root: Path, att, tmp: Path) -> None:
    """18 (h): ``caption --method diverse``, ``--method mbr --mbr-from
    beam``, ``--ensemble-with`` (a bundle of the same checkpoint) on phase
    8's checkpoint, and ``--dump-attention`` on CONFIG_4's attention decoder
    saved as a checkpoint, as subprocesses side by side: the first three
    print the lines of the library calls on the restored pipeline, the dump
    holds tpucap's keys and dtypes and the printed captions."""
    from tpucap_torch.checkpoint import CheckpointManager
    from tpucap_torch.cli.main import _restore_pipeline, build_parser
    from tpucap_torch.pipeline import CaptioningPipeline
    from tpucap_torch.train import TrainState, build_optimizer

    ckpt = cli_root / "ckpt"
    images = [str(p) for p in sorted((cli_root / "images").glob("*.jpg"))[:CLI_CAPTIONED]]
    base = ["caption", *CLI_MODEL, "--image", *images, "--checkpoint-dir", str(ckpt)]
    pipe = _restore_pipeline(build_parser()[0].parse_args(base), dev)
    bundle = tmp / "bundle"
    pipe.save(bundle)
    att_ckpt, dump = tmp / "att_ckpt", tmp / "att.npz"
    CheckpointManager(att_ckpt).save(TrainState.create(
        att.params["decoder"], build_optimizer(att.config.train), torch.Generator(device=dev)))
    att.tokenizer.save(str(att_ckpt / "tokenizer.json"))
    runs = {
        "diverse": base + ["--method", "diverse", "--diverse-groups", str(P18_GROUPS)],
        "mbr": base + ["--method", "mbr", "--mbr-from", "beam", "--mbr-candidates", str(P18_POOL)],
        "ensemble": base + ["--ensemble-with", str(bundle)],
        "dump-attention": ["caption", "--preset", "config4", "--decoder", "attention", "--image", *images,
                           "--checkpoint-dir", str(att_ckpt), "--method", "greedy", "--dump-attention", str(dump)],
    }
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-m", "tpucap_torch", *argv], cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, argv in runs.items()}
    done = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            if proc.returncode:
                raise AssertionError(f"toolkit cli {name} exited {proc.returncode}: {err[-2000:]}")
            done[name] = out.splitlines()
    finally:
        for proc in procs.values():
            proc.kill()
    wall = time.perf_counter() - t0
    feats = pipe.extract_features(images)
    other = CaptioningPipeline.load(bundle, device=dev)
    want = {
        "diverse": [f"{p}\t[group {g} {s:.3f}] {c}" for p, row in zip(images, pipe.generate_diverse(
            feats, num_groups=P18_GROUPS, group_width=BEAM)) for g, (c, s) in enumerate(row)],
        "mbr": [f"{p}\t{c}" for p, c in zip(images, pipe.generate_mbr(
            feats, n_candidates=P18_POOL, candidates="beam", beam_width=BEAM))],
        "ensemble": [f"{p}\t{c}" for p, c in zip(images, pipe.generate_ensemble(
            [feats, other.extract_features(images)], [other], method="beam", beam_width=BEAM))],
    }
    for name, lines in want.items():
        if done[name] != lines:
            raise AssertionError(f"toolkit cli {name}: printed {done[name][:3]}, the library gives {lines[:3]}")
    npz = np.load(dump)
    caps = [ln.split("\t", 1)[1] for ln in done["dump-attention"]]
    alphas, lengths = npz["alphas"], npz["lengths"]
    live = np.arange(alphas.shape[1])[None, :] < lengths[:, None]
    if (npz.files != ["alphas", "lengths", "captions", "images", "spatial_positions"]
            or alphas.dtype != np.float32 or lengths.dtype != np.int32
            or npz["spatial_positions"].dtype != np.int32 or list(npz["captions"]) != caps
            or list(npz["images"]) != images or alphas.shape != (len(images), MAX_LEN, int(npz["spatial_positions"]))
            or not np.allclose(alphas.sum(-1)[live], 1.0, atol=P18_ALPHA_ATOL)):
        raise AssertionError(f"toolkit cli dump-attention: {npz.files} {alphas.shape} {alphas.dtype} {lengths}")
    log(f"toolkit cli: caption {' '.join(CLI_MODEL)} on phase 8's checkpoint, {len(images)} images, as "
        f"subprocesses side by side ({wall:.2f} s): --method diverse --diverse-groups {P18_GROUPS}, "
        f"--method mbr --mbr-from beam and --ensemble-with its bundle printed the library calls' lines; "
        f"--preset config4 --decoder attention --dump-attention wrote {npz.files}, alphas {alphas.shape} "
        f"f32, lengths int32, each live map summing to 1")
    for ln in done["diverse"][:P18_GROUPS]:
        log(f"toolkit cli diverse: {ln!r}")


def run_toolkit(dev, tokenizer, smi: str, cli_root: Path) -> dict[str, int]:
    """Phase 18, one launch window over (a)-(g) and (j): K2 and K3's
    kernels once a counted step of each lstm1 member, K4 12 times a counted
    encoder pass of path A, K1 once an image batch, nothing else (the
    attention decoder's step is plain); then the CLI's subprocesses. -> the
    window's launches."""
    from tpucap_torch import ops

    a, b = (served_pipeline("f32", tokenizer, seed=s) for s in (0, 1))
    att = preset_pipeline("config4", tokenizer)
    att.config = dataclasses.replace(att.config, precision="f32")
    works = [DialWork(a), DialWork(b)]
    g = torch.Generator(device=dev).manual_seed(180)
    feats = torch.randn((P18_ROWS, DEC_FEATURES), generator=g, device=dev)
    images = torch.randint(0, 256, (P18_ROWS, IMAGE, IMAGE, 3), generator=g, device=dev, dtype=torch.uint8)
    log(f"toolkit: path A (resnet50 fused_blocks + lstm1, vocab {VOCAB}, beam {BEAM}, max_len {MAX_LEN}) "
        f"seeds 0 and 1, CONFIG_4 (vgg16 spatial + attention) in f32; {P18_ROWS} rows of {DEC_FEATURES}-d "
        f"features, {P18_ROWS} uint8 images at {IMAGE}")
    ops.reset_launch_counts()
    try:
        pooled, grids = toolkit_encode(a, images), toolkit_encode(att, images)
        toolkit_diverse(a, works[0], feats)
        toolkit_ensemble(a, b, att, feats, pooled, grids)
        toolkit_mbr(a, feats)
        toolkit_attention(att, grids)
        for p in (a, b):
            p.config = dataclasses.replace(p.config, precision="bf16")
        toolkit_times(a, b, works[0], feats, smi)
        counts = ops.launch_counts()
    finally:
        for work in reversed(works):
            work.close()
    steps = sum(w.steps for w in works)
    encodes = sum(w.encodes for w in works)
    expect = {name: {"preprocess_u8": 2, "lstm_cell": steps, "merge_head": steps, "vocab_proj": steps,
                     "identity_block": 12 * encodes}.get(name, 0) for name in counts}
    log(f"toolkit: launches over phase 18 {counts}; {steps} counted steps ({works[1].steps} of them member "
        f"1's), {encodes} encoder passes")
    if counts != expect or not works[1].steps or encodes != 1:
        raise AssertionError(f"toolkit: launches {counts}, the counted work asks for {expect}")
    del a, b
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        toolkit_cli(dev, cli_root, att, Path(tmp))
    return counts


# Phase 19, the GRU and adaptive decoders: (b)'s rows, the most of them
# that may part at a near-tie, and the f32 first-step logits' bound on the
# card against the CPU (cuBLAS with TF32 off against the host's BLAS: the
# same products summed in another order over K = 2048 and 256, logits of
# O(1)); (c)'s images; (e)'s served batches and rows a batch; (f)'s decoded
# rows.
P19_ROWS, P19_PARTED, P19_LOGIT_ATOL = 32, 8, 1e-4
P19_IMAGES, P19_SERVED, P19_SERVED_ROWS, P19_DECODED = 64, 4, 16, 64


def gru_paths(dev, tokenizer) -> tuple[dict, dict[str, int]]:
    """19 (a): path A (ResNet-50 BN folded with ``fused_blocks``) into gru1,
    then gru2, at phase 3's widths, bf16: one batch of ``caption_batch``
    with the counters reset just before and read just after (K1 1, K4 12,
    K2 and K3 0: the GRU step is plain), captions/s and ms a decode step.
    -> ({name: pipeline}, the counted batches' launches)."""
    pipes, total = {}, {}
    for name in ("gru1", "gru2"):
        pipe = make_pipeline("bf16", tokenizer, decoder=name)
        pipe.encoder = dataclasses.replace(pipe.encoder, fused_blocks=True)
        log(f"decoders {name}: batch {BATCH} resnet50(fused_blocks=True)+{name} embed/hidden {WIDTH} beam "
            f"{BEAM} vocab {VOCAB} max_len {MAX_LEN} bf16")
        work = DialWork(pipe)
        try:
            counts = run_path(dev, f"decoders {name}", pipe, {"identity_block": 12}, work=work)
        finally:
            work.close()
            del pipe.step_fn, pipe._apply_encoder  # the class's own again
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        pipes[name] = pipe
    return pipes, total


def gru_agreement(dev, pipe) -> None:
    """19 (b): f32 (TF32 off), P19_ROWS rows of seeded features: gru1's
    first decode step on the card against the same step on the CPU within
    P19_LOGIT_ATOL, then greedy decodes of the rows on both; rows that part
    (a near-tie taken the other way) are logged, more than P19_PARTED
    fail."""
    from tpucap_torch.core import precision_flags, tree_map
    from tpucap_torch.decode import greedy_decode

    dec, params = pipe.decoder, pipe.params["decoder"]  # f32 masters
    start, end = pipe._token_ids()
    feats = torch.randn((P19_ROWS, DEC_FEATURES), generator=torch.Generator().manual_seed(190))
    out = {}
    with torch.inference_mode(), precision_flags("f32"):
        for where, p in (("card", params), ("cpu", tree_map(lambda t: t.cpu(), params))):
            x = feats.to(dev if where == "card" else "cpu")
            first = torch.full((P19_ROWS,), start, dtype=torch.long, device=x.device)
            logits, _ = dec.step(p, dec.init_state(p, x), first)
            res = greedy_decode(dec.step, p, dec.init_state(p, x), start_id=start, end_id=end, max_len=MAX_LEN)
            out[where] = (logits.float().cpu(), res.tokens.cpu(), res.lengths.cpu())
    err = max_err(out["card"][0], out["cpu"][0])
    if not err <= P19_LOGIT_ATOL:
        raise AssertionError(f"decoders gru1 f32: first-step logits {err:.3g} from the CPU's")
    parted = []
    for i in range(P19_ROWS):
        a, b = out["card"][1][i], out["cpu"][1][i]
        if not torch.equal(a, b):
            t = int((a != b).nonzero()[0])
            parted.append(f"row {i} from step {t}")
    if parted:
        log(f"decoders gru1 f32: {len(parted)} of {P19_ROWS} rows parted at a near-tie: {parted[:8]}")
    if len(parted) > P19_PARTED:
        raise AssertionError(f"decoders gru1 f32: {len(parted)} of {P19_ROWS} greedy rows differ from the CPU's")
    log(f"decoders gru1 f32 (TF32 off), {P19_ROWS} rows: first-step logits (vocab {VOCAB}) within {err:.3g} "
        f"of the CPU's (bound {P19_LOGIT_ATOL}); greedy tokens equal in {P19_ROWS - len(parted)} of "
        f"{P19_ROWS} rows; lengths {out['card'][2].min().item()}-{out['card'][2].max().item()}")


def adaptive_path(dev, tokenizer) -> tuple[object, dict[str, int]]:
    """19 (c): CONFIG_4's encoder (VGG16's 14 x 14 x 512 grid at 224, caffe
    mode) into the adaptive decoder (embed, hidden and attention 256), beam
    BEAM, bf16, P19_IMAGES uint8 images: one ``caption_batch`` with the
    counters reset just before and read just after (K1 1, nothing else: the
    step is plain), ``val`` and ``att_feat`` (B, 196, .) inside every step
    beside h (B * BEAM, .); then in f32 the images' grids (K1 1) and
    ``generate_with_attention``'s beam maps: (B, max_len, 197), every row
    summing to 1 within P18_ALPHA_ATOL, column 196 (the sentinel's beta) in
    [0, 1]. -> (the pipeline, the launches)."""
    from tpucap_torch import ops

    pipe = preset_pipeline("config4", tokenizer, name="adaptive")
    pipe.config = dataclasses.replace(pipe.config, precision="bf16")
    enc, dec, cfg = pipe.encoder, pipe.decoder, pipe.config.decoder
    L = enc.spatial_positions
    g = torch.Generator(device=dev).manual_seed(191)
    images = torch.randint(0, 256, (P19_IMAGES, enc.input_size, enc.input_size, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    pipe.caption_batch(images[:8])  # warm-up
    shapes, steps = set(), []

    def observe(p, state, token):
        shapes.add((tuple(state["val"].shape), tuple(state["att_feat"].shape), tuple(state["h"].shape)))
        steps.append(1)
        return dec.step(p, state, token)

    pipe.step_fn = lambda: observe
    ops.reset_launch_counts()
    try:
        caps, s = timed(lambda: pipe.caption_batch(images))
        counts = ops.launch_counts()
    finally:
        del pipe.step_fn
    check_counts("decoders adaptive", counts, 1, decode=False)
    want = ((P19_IMAGES, L, cfg.hidden_dim), (P19_IMAGES, L, cfg.attention_dim), (P19_IMAGES * BEAM, cfg.hidden_dim))
    if shapes != {want} or len(caps) != P19_IMAGES:
        raise AssertionError(f"decoders adaptive: state shapes in the beam {shapes}, expected {want}")
    log(f"decoders adaptive: {P19_IMAGES} images at {enc.input_size} (caffe), vgg16 spatial {L} x "
        f"{pipe.config.encoder.feature_dim} + adaptive "
        f"(embed/hidden/attention {cfg.embed_dim}/{cfg.hidden_dim}/{cfg.attention_dim}), beam {BEAM}, bf16: "
        f"caption_batch {s:.5f} s ({P19_IMAGES / s:.2f} captions/s, {len(steps)} steps); launches K1 1, no "
        f"other kernel; inside every step val {want[0]} and att_feat {want[1]} beside h {want[2]}; "
        f"{len(set(caps))} distinct captions; {caps[0]!r}")

    pipe.config = dataclasses.replace(pipe.config, precision="f32")
    ops.reset_launch_counts()
    grids = toolkit_encode(pipe, images)
    more = ops.launch_counts()
    check_counts("decoders adaptive grids", more, 1, decode=False)
    caps, alphas, lengths = pipe.generate_with_attention(grids, method="beam")
    T = pipe.config.decode.max_len
    sums = float(np.abs(alphas.sum(-1) - 1.0).max())
    beta = alphas[..., L]
    live = np.arange(T)[None, :] < lengths[:, None]
    if (alphas.shape != (P19_IMAGES, T, L + 1) or not sums <= P18_ALPHA_ATOL
            or not ((beta >= 0) & (beta <= 1)).all() or caps != pipe.generate(grids, method="beam")):
        raise AssertionError(f"decoders adaptive maps {alphas.shape}: sums within {sums:.3g}, beta "
                             f"{beta.min():.3g}-{beta.max():.3g}")
    log(f"decoders adaptive maps: f32 beam {BEAM}, alphas {alphas.shape} (the grid's {L} columns, then the "
        f"sentinel's beta), every row summing to 1 within {sums:.3g}; beta {beta.min():.4f}-{beta.max():.4f}, "
        f"mean {float(beta[live].mean()):.4f} over {int(live.sum())} live steps; the captions generate's")
    return pipe, {k: counts[k] + more[k] for k in counts}


def gru_server(pipe) -> None:
    """19 (e): a ``CaptionHTTPServer`` (batch engine, max_batch
    P19_SERVED_ROWS) on (a)'s gru1 pipeline answers P19_SERVED batches of
    P19_SERVED_ROWS feature rows, each one device batch (``/caption_batch``
    through the features batcher), with ``generate``'s captions of the same
    rows."""
    from tpucap_torch import ops
    from tpucap_torch.client import CaptionClient
    from tpucap_torch.serve_http import CaptionHTTPServer

    srv = CaptionHTTPServer(pipe, host="127.0.0.1", port=0, max_batch=P19_SERVED_ROWS)
    addr = srv.serve_background()
    g = np.random.default_rng(192)
    ops.reset_launch_counts()
    try:
        client = CaptionClient(*addr)
        t0 = time.perf_counter()
        for i in range(P19_SERVED):
            rows = g.normal(size=(P19_SERVED_ROWS, DEC_FEATURES)).astype(np.float32)
            got = client.caption_features_many(rows)
            want = pipe.generate(rows)
            if got != want:
                raise AssertionError(f"decoders gru1 server batch {i}: {got[:2]} against generate's {want[:2]}")
        wall = time.perf_counter() - t0
    finally:
        srv.close()
    check_counts("decoders gru1 server", ops.launch_counts(), 0, decode=False)
    log(f"decoders gru1 server: {P19_SERVED} batches of {P19_SERVED_ROWS} feature rows through "
        f"http://{addr[0]}:{addr[1]}, each generate's captions of its rows ({wall:.3f} s with the "
        f"generate calls); no kernel launched")


def gru_keras(pipes, root: Path) -> None:
    """19 (f): gru1 and gru2 at vocab VOCAB through ``export_h5`` and
    ``gru_merge_decoder_params_from_keras``: params bit for bit, then greedy
    and beam tokens of P19_DECODED rows token for token (``reimport_decodes``)."""
    from tpucap_torch.checkpoint import KerasH5Model, export_h5, gru_merge_decoder_params_from_keras

    x = np.random.default_rng(193).normal(size=(P19_DECODED, DEC_FEATURES)).astype(np.float32)
    for name, pipe in pipes.items():
        path = root / f"{name}.h5"
        _, export_s = timed(lambda: export_h5(pipe.decoder, pipe.params["decoder"], path, max_len=MAX_LEN))
        view, read_s = timed(lambda: KerasH5Model(path))
        log(f"decoders keras {name}: {len(view.layers)} layers, {path.stat().st_size / 2**20:.2f} MiB written "
            f"in {export_s:.5f} s, read back {read_s:.5f} s")
        counts = reimport_decodes(f"decoders keras {name}", pipe, gru_merge_decoder_params_from_keras(view), x)
        if any(counts.values()):
            raise AssertionError(f"decoders keras {name}: kernels launched {counts}; the GRU step is plain")


def run_decoders(dev, tokenizer) -> dict[str, int]:
    """Phase 19: (a) path A into gru1 and gru2, (b) gru1's f32 step on the
    card against the CPU, (c) CONFIG_4's grid into the adaptive decoder and
    its L+1 maps, (d) the two families' training steps, (e) a server on
    gru1, (f) gru1 and gru2 through Keras ``.h5``. -> (a)'s and (c)'s
    counted launches."""
    pipes, counts = gru_paths(dev, tokenizer)
    gru_agreement(dev, pipes["gru1"])
    adaptive, more = adaptive_path(dev, tokenizer)
    counts = {k: counts[k] + more[k] for k in counts}
    L, D = adaptive.encoder.spatial_positions, adaptive.config.encoder.feature_dim
    del adaptive
    torch.cuda.empty_cache()
    for name, shape, kw in (("gru1", (DEC_TRAIN_BATCH, DEC_FEATURES), {}),
                            ("adaptive", (P19_IMAGES, L, D), {"attention_reg": 1.0})):
        losses = decoder_train_steps(dev, "decoders train", name, shape, **kw)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"decoders train {name}: losses {losses} do not fall on one batch")
    gru_server(pipes["gru1"])
    with tempfile.TemporaryDirectory() as tmp:
        gru_keras(pipes, Path(tmp))
    return counts


# Phase 20, the transformer decoder at tpucap's DecoderConfig defaults (2
# layers, 4 heads, MLP 1024, max_positions 40; hidden WIDTH) and an MoE
# variant (make_moe's 8 experts, top-2): (b)'s rows, the most of them that
# may part at a near-tie, and the f32 first-step logits' bound on the card
# against the CPU (phase 19's); (c)'s rows, longest prefix, rows that may
# part, and the KV-cache capacity its prefixes need (8 words + MAX_LEN);
# (d)'s admission waves and ticks a sync group; (f)'s batches, rows a
# batch and the capacity-breaking prefix's words; (g)'s images and the
# maps' row-sum bound.
P20_EXPERTS, P20_TOP_K = 8, 2
P20_ROWS, P20_PARTED, P20_LOGIT_ATOL = 32, 2, 1e-4
P20_PREFIX_ROWS, P20_PREFIX_WORDS, P20_PREFIX_PARTED, P20_PREFIX_POSITIONS = 64, 8, 4, 48
P20_WAVES, P20_TICKS = 3, 4
P20_SERVED, P20_SERVED_ROWS, P20_OVER_WORDS = 4, 16, 7
P20_IMAGES, P20_ALPHA_ATOL = 64, 1e-6


def transformer_pipeline(precision: str, tokenizer, experts: int = 0, shrink: bool = True,
                         features: str = "pooled", max_positions: int = 40):
    """ResNet-50 (BN folded) into the transformer decoder at tpucap's
    DecoderConfig defaults and hidden WIDTH, vocab VOCAB, beam BEAM,
    max_len MAX_LEN, random weights from seed 0. ``shrink`` scales the
    memory projection by 1e-3, as ``make_pipeline`` scales lstm1's image
    branch, for ResNet-50's large, nearly alike features of noise images."""
    from tpucap_torch.config import Config, DecodeConfig, DecoderConfig, encoder_config
    from tpucap_torch.pipeline import CaptioningPipeline

    cfg = Config(
        encoder=encoder_config("resnet50", features),
        decoder=DecoderConfig(name="transformer", hidden_dim=WIDTH, num_layers=2, max_positions=max_positions,
                              num_experts=experts, moe_top_k=P20_TOP_K),
        decode=DecodeConfig(method="beam", beam_width=BEAM, max_len=MAX_LEN),
        precision=precision,
    )
    pipe = CaptioningPipeline(cfg, tokenizer=tokenizer)
    pipe.build(seed=0)
    if shrink:
        pipe.params["decoder"]["mem_proj"]["kernel"].mul_(1e-3)
    pipe.fold_bn()
    return pipe


def transformer_paths(dev, tokenizer) -> dict[str, int]:
    """20 (a): path A into lstm1 (K2 + K3), the dense transformer and the
    MoE one, bf16, beam BEAM then greedy: one batch of ``caption_batch``
    each with the counters reset just before and read just after (K1 1, K4
    12; K2 and K3 one a step for lstm1, none for the transformer), captions/s
    and ms a decode step side by side. -> the counted batches' launches."""
    total: dict[str, int] = {}
    for label, experts in (("lstm1", None), ("transformer", 0), ("transformer moe", P20_EXPERTS)):
        if experts is None:
            pipe = served_pipeline("bf16", tokenizer)
        else:
            pipe = transformer_pipeline("bf16", tokenizer, experts=experts)
            pipe.encoder = dataclasses.replace(pipe.encoder, fused_blocks=True)
        d = pipe.config.decoder
        log(f"transformer paths {label}: batch {BATCH} resnet50(fused_blocks=True)+{d.name} hidden "
            f"{d.hidden_dim}" + ("" if experts is None else
                                 f" layers {d.num_layers} heads {d.num_heads} mlp {d.mlp_dim} max_positions "
                                 f"{d.max_positions} experts {d.num_experts} top-{d.moe_top_k}")
            + f" vocab {VOCAB} max_len {MAX_LEN} bf16")
        for method in ("beam", "greedy"):
            pipe.config = dataclasses.replace(pipe.config, decode=dataclasses.replace(pipe.config.decode,
                                                                                      method=method))
            if experts is None:
                counts = run_path(dev, f"transformer paths {label} {method}", pipe, {"identity_block": 12})
            else:
                work = DialWork(pipe)
                try:
                    counts = run_path(dev, f"transformer paths {label} {method}", pipe, {"identity_block": 12},
                                      work=work)
                finally:
                    work.close()
                    del pipe.step_fn, pipe._apply_encoder  # the class's own again
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del pipe
        torch.cuda.empty_cache()
    return total


@contextlib.contextmanager
def router_picks():
    """Record each MoE layer's sorted top-k expert indices (host tensors,
    in call order) while the block runs."""
    import tpucap_torch.models.decoders.transformer as tmod

    picks, topk = [], tmod.topk_stable

    def recorded(x, k):
        vals, idx = topk(x, k)
        picks.append(idx.sort(dim=-1).values.cpu())
        return vals, idx

    tmod.topk_stable = recorded
    try:
        yield picks
    finally:
        tmod.topk_stable = topk


def transformer_agreement(pipe, label: str) -> None:
    """20 (b): f32 (TF32 off), P20_ROWS rows of seeded features: the first
    decode step on the card against the same step on the CPU within
    P20_LOGIT_ATOL (rows whose router chose another top-k set in a layer are
    logged and left out), greedy decodes on both, rows parted at a near-tie
    logged, more than P20_PARTED fail; for the MoE model, the tokens of a
    teacher-forced pass over the CPU's greedy captions whose top-k expert
    set differs between card and CPU, counted."""
    from tpucap_torch.core import precision_flags, tree_map
    from tpucap_torch.decode import greedy_decode

    dec, params = pipe.decoder, pipe.params["decoder"]
    start, end = pipe._token_ids()
    feats = torch.randn((P20_ROWS, DEC_FEATURES), generator=torch.Generator().manual_seed(200))
    out = {}
    with torch.inference_mode(), precision_flags("f32"):
        for where, p in (("card", params), ("cpu", tree_map(lambda t: t.cpu(), params))):
            x = feats.to(dev_of(p))
            first = torch.full((P20_ROWS,), start, dtype=torch.long, device=x.device)
            with router_picks() as picks:
                logits, _ = dec.step(p, dec.init_state(p, x), first)
            res = greedy_decode(dec.step, p, dec.init_state(p, x), start_id=start, end_id=end, max_len=MAX_LEN)
            out[where] = (logits.float().cpu(), res.tokens.cpu(), res.lengths.cpu(), picks)
        tokens, lengths = out["cpu"][1], out["cpu"][2]
        forced = torch.cat([torch.full_like(tokens[:, :1], start), tokens[:, :-1]], dim=1)
        routed = {}
        for where, p in (("card", params), ("cpu", tree_map(lambda t: t.cpu(), params))):
            with router_picks() as picks:
                dec.forward_train(p, feats.to(dev_of(p)), forced.to(dev_of(p)))
            routed[where] = picks
    first_flip = torch.zeros(P20_ROWS, dtype=torch.bool)
    for a, b in zip(out["card"][3], out["cpu"][3]):
        first_flip |= (a != b).any(dim=-1).reshape(P20_ROWS, -1).any(dim=-1)
    keep = ~first_flip
    err = max_err(out["card"][0][keep], out["cpu"][0][keep])
    if not err <= P20_LOGIT_ATOL:
        raise AssertionError(f"transformer {label} f32: first-step logits {err:.3g} from the CPU's")
    parted = []
    for i in range(P20_ROWS):
        a, b = out["card"][1][i], out["cpu"][1][i]
        if not torch.equal(a, b):
            parted.append(f"row {i} from step {int((a != b).nonzero()[0])}")
    if parted:
        log(f"transformer {label} f32: {len(parted)} of {P20_ROWS} rows parted at a near-tie: {parted[:8]}")
    if len(parted) > P20_PARTED:
        raise AssertionError(f"transformer {label} f32: {len(parted)} of {P20_ROWS} greedy rows differ from "
                             "the CPU's")
    moe = ""
    if dec.num_experts:
        live = (torch.arange(MAX_LEN)[None, :] < lengths[:, None])
        changed = sum(int(((a != b).any(dim=-1) & live).sum()) for a, b in zip(routed["card"], routed["cpu"]))
        moe = (f"; router: {int(first_flip.sum())} of {P20_ROWS} rows chose another top-{dec.moe_top_k} set "
               f"at the first step, {changed} of {int(live.sum()) * dec.num_layers} token routings of a "
               f"teacher-forced pass over the CPU's captions changed their set between card and CPU")
    log(f"transformer {label} f32 (TF32 off), {P20_ROWS} rows: first-step logits (vocab {VOCAB}) within "
        f"{err:.3g} of the CPU's (bound {P20_LOGIT_ATOL}); greedy tokens equal in {P20_ROWS - len(parted)} "
        f"of {P20_ROWS} rows; lengths {lengths.min().item()}-{lengths.max().item()}{moe}")


def dev_of(tree):
    from tpucap_torch.core import tree_leaves

    return tree_leaves(tree)[0].device


def transformer_prefix(dev, tokenizer) -> None:
    """20 (c): ``generate_continuation`` beam BEAM in f32 on
    P20_PREFIX_ROWS rows with prefixes of 0 ... P20_PREFIX_WORDS words in
    turn, the prefix primed in one ``step_chunk`` (the pipeline's route)
    against the step loop (``prime_prefix`` without the decoder): captions
    token for token but for at most P20_PREFIX_PARTED rows parted at a
    near-tie (logged with the f32 logit gap), the ms of each prime."""
    import tpucap_torch.pipeline as pipeline_mod

    pipe = transformer_pipeline("f32", tokenizer, shrink=False, max_positions=P20_PREFIX_POSITIONS)
    g = torch.Generator(device=dev).manual_seed(201)
    feats = torch.randn((P20_PREFIX_ROWS, DEC_FEATURES), generator=g, device=dev)
    rng, words = np.random.default_rng(202), vocab_words(tokenizer)
    prefixes = [" ".join(str(w) for w in rng.choice(words, i % (P20_PREFIX_WORDS + 1), replace=False))
                for i in range(P20_PREFIX_ROWS)]
    prime, times = pipeline_mod.prime_prefix, {}

    def routed(route):
        def primed(step, *a, **kw):
            if route == "scan":
                kw["decoder"] = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = prime(step, *a, **kw)
            torch.cuda.synchronize()
            times.setdefault(route, []).append(time.perf_counter() - t0)
            return r
        return primed

    caps = {}
    try:
        for route in ("chunk", "scan", "chunk", "scan"):
            pipeline_mod.prime_prefix = routed(route)
            caps[route] = pipe.generate_continuation(feats, prefixes, method="beam")
    finally:
        pipeline_mod.prime_prefix = prime
    for h, c in zip(prefixes, caps["chunk"]):
        if not c.startswith(h):
            raise AssertionError(f"transformer prefix: {c!r} does not open with {h!r}")
    rows = [i for i, (a, b) in enumerate(zip(caps["chunk"], caps["scan"])) if a != b]
    if rows:
        log(f"transformer prefix: {len(rows)} of {P20_PREFIX_ROWS} rows parted at a near-tie: "
            f"{logit_gaps(pipe, feats, caps['chunk'], caps['scan'])[:8]}")
    if len(rows) > P20_PREFIX_PARTED:
        raise AssertionError(f"transformer prefix: {len(rows)} of {P20_PREFIX_ROWS} chunk-primed captions "
                             "differ from the step loop's")
    log(f"transformer prefix: f32 beam {BEAM}, {P20_PREFIX_ROWS} rows, prefixes of 0-{P20_PREFIX_WORDS} words "
        f"(padded to 8), max_positions {P20_PREFIX_POSITIONS}: the chunk-primed captions the step loop's in "
        f"{P20_PREFIX_ROWS - len(rows)} of {P20_PREFIX_ROWS} rows; the prime {times['chunk'][1] * 1e3:.3f} ms "
        f"in one step_chunk, {times['scan'][1] * 1e3:.3f} ms in 8 steps (warm calls; cold "
        f"{times['chunk'][0] * 1e3:.3f} / {times['scan'][0] * 1e3:.3f}); {caps['chunk'][1]!r}")


def drive_lanes(eng, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Admit feats' rows in P20_WAVES waves, one a sync group of P20_TICKS
    ticks, into lanes (request i in lane i), collect them as they finish.
    -> (tokens, lengths) by request."""
    n = feats.shape[0]
    per = -(-n // P20_WAVES)
    tokens = torch.zeros((n, MAX_LEN), dtype=torch.long)
    lengths = torch.zeros((n,), dtype=torch.long)
    state, admitted, left, syncs = eng.init_state(), 0, set(range(n)), 0
    while left:
        if admitted < n:
            ids = list(range(admitted, min(n, admitted + per)))
            idx, x = eng.pad_admission(ids, [feats[i].cpu().numpy() for i in ids])
            state = eng.admit(state, idx, x)
            admitted = ids[-1] + 1
        state = eng.tick(state, P20_TICKS)
        done = [i for i in torch.nonzero(eng.flags(state)[0]).flatten().tolist() if i in left]
        if done:
            (tok, lens, _), state = eng.collect(state, np.asarray(done))
            tokens[done], lengths[done] = tok.cpu(), lens.cpu()
            left -= set(done)
        syncs += 1
        if syncs > 4 * MAX_LEN:
            raise AssertionError(f"continuous lanes: {sorted(left)[:8]} never finished")
    return tokens, lengths


def transformer_lanes(pipe) -> None:
    """20 (d): f32, both continuous engines on the dense model, one lane or
    beam group a request, P20_PREFIX_ROWS requests admitted in P20_WAVES
    waves P20_TICKS ticks apart (lanes at different depths: per-lane
    positions): the captions ``generate``'s, token for token."""
    from tpucap_torch.decode import ContinuousBeamEngine, ContinuousDecodeEngine, ids_to_captions

    start, end = pipe._token_ids()
    g = torch.Generator(device=pipe.device).manual_seed(203)
    feats = torch.randn((P20_PREFIX_ROWS, DEC_FEATURES), generator=g, device=pipe.device)
    kw = dict(slots=P20_PREFIX_ROWS, start_id=start, end_id=end, max_len=MAX_LEN, precision="f32")
    for method, eng in (("greedy", ContinuousDecodeEngine(pipe.decoder, pipe.params["decoder"], **kw)),
                        ("beam", ContinuousBeamEngine(pipe.decoder, pipe.params["decoder"], beam_width=BEAM,
                                                      **kw))):
        (tokens, lengths), s = timed(lambda: drive_lanes(eng, feats))
        got = ids_to_captions(pipe.tokenizer, tokens, lengths, end_id=end)
        want = pipe.generate(feats, method=method)
        if got != want:
            why = logit_gaps(pipe, feats, got, want)
            raise AssertionError(f"transformer lanes {method}: {len(why)} of {len(want)} captions differ "
                                 f"from generate's: {why[:8]}")
        log(f"transformer lanes {method}: f32, {P20_PREFIX_ROWS} requests in {P20_WAVES} waves "
            f"{P20_TICKS} ticks apart, {P20_PREFIX_ROWS} slots: generate's captions token for token "
            f"({s:.3f} s); lengths {lengths.min().item()}-{lengths.max().item()}")


def transformer_server(pipe, tokenizer) -> None:
    """20 (f): a batch ``CaptionServer`` (max_batch P20_SERVED_ROWS) on the
    f32 dense model answers P20_SERVED batches of P20_SERVED_ROWS feature
    rows with ``generate``'s captions, one of them with a shared prefix
    (``generate_continuation``'s, primed in one step_chunk); a request
    whose prefix breaks the KV capacity is refused alone, the batch beside
    it answered."""
    from tpucap_torch.serve import CaptionServer

    g = np.random.default_rng(204)
    words = vocab_words(tokenizer)
    head = " ".join(str(w) for w in g.choice(words, 3, replace=False))
    over = " ".join(str(w) for w in g.choice(words, P20_OVER_WORDS, replace=False))
    t0 = time.perf_counter()
    with CaptionServer(pipe, max_batch=P20_SERVED_ROWS) as srv:
        for i in range(P20_SERVED):
            rows = g.normal(size=(P20_SERVED_ROWS, DEC_FEATURES)).astype(np.float32)
            if i == 1:
                futs = srv.submit_many(rows, prefix=head)
                try:
                    srv.submit(rows[0], prefix=over)
                except ValueError as e:
                    refused = str(e)
                else:
                    raise AssertionError("transformer server: a prefix past the KV capacity was admitted")
                want = pipe.generate_continuation(rows, head)
            else:
                futs = srv.submit_many(rows)
                want = pipe.generate(rows)
            got = [f.result(120) for f in futs]
            if got != want:
                raise AssertionError(f"transformer server batch {i}: {got[:2]} against the library's {want[:2]}")
    if "max_positions" not in refused:
        raise AssertionError(f"transformer server: the capacity refusal reads {refused!r}")
    log(f"transformer server: {P20_SERVED} batches of {P20_SERVED_ROWS} f32 feature rows, each the library's "
        f"captions (batch 1 with the prefix {head!r}, primed in one step_chunk); a {P20_OVER_WORDS}-word prefix "
        f"refused alone: {refused!r} ({time.perf_counter() - t0:.3f} s)")


def transformer_maps(dev, tokenizer) -> dict[str, int]:
    """20 (g): ResNet-50's spatial grid (conv4, 14 x 14 x 1024 at 224, BN
    folded) of P20_IMAGES uint8 images (K1 once, counted) into the dense
    transformer, f32: ``generate_with_attention``'s beam maps (images, T,
    196), every row summing to 1 within P20_ALPHA_ATOL, the captions
    ``generate``'s. -> the encode's launches."""
    from tpucap_torch import ops

    pipe = transformer_pipeline("f32", tokenizer, features="spatial")
    L = pipe.encoder.spatial_positions
    g = torch.Generator(device=dev).manual_seed(205)
    images = torch.randint(0, 256, (P20_IMAGES, IMAGE, IMAGE, 3), generator=g, device=dev, dtype=torch.uint8)
    ops.reset_launch_counts()
    grids = toolkit_encode(pipe, images)
    counts = ops.launch_counts()
    check_counts("transformer maps", counts, 1, decode=False)
    (caps, alphas, lengths), s = timed(lambda: pipe.generate_with_attention(grids, method="beam"))
    sums = float(np.abs(alphas.sum(-1) - 1.0).max())
    if (alphas.shape != (P20_IMAGES, MAX_LEN, L) or not sums <= P20_ALPHA_ATOL
            or caps != pipe.generate(grids, method="beam")):
        raise AssertionError(f"transformer maps {alphas.shape}: sums within {sums:.3g}")
    log(f"transformer maps: f32 beam {BEAM}, {P20_IMAGES} images, resnet50 spatial {L} x "
        f"{pipe.config.encoder.feature_dim}: alphas {alphas.shape} (the last layer's head-averaged "
        f"cross-attention), every row summing to 1 within {sums:.3g}, the largest weight a row "
        f"{float(alphas.max(-1).mean()):.4f} on average; the captions generate's ({s:.3f} s)")
    return counts


def run_transformer(dev, tokenizer) -> dict[str, int]:
    """Phase 20: (a) path A into lstm1, the dense and the MoE transformer,
    (b) the f32 steps on the card against the CPU, (c) chunked priming
    against the step loop, (d) both continuous engines, (e) the training
    steps, (f) a batch server, (g) the maps on ResNet-50's grid. (b)-(d)
    and (f) launch no kernel. -> (a)'s and (g)'s counted launches."""
    from tpucap_torch import ops

    counts = transformer_paths(dev, tokenizer)
    dense = transformer_pipeline("f32", tokenizer, shrink=False)
    moe = transformer_pipeline("f32", tokenizer, experts=P20_EXPERTS, shrink=False)
    ops.reset_launch_counts()
    transformer_agreement(dense, "dense")
    transformer_agreement(moe, "moe")
    del moe
    transformer_prefix(dev, tokenizer)
    transformer_lanes(dense)
    transformer_server(dense, tokenizer)
    check_launches("transformer (b)-(d), (f)", ops.launch_counts(), {}, decode=False)
    del dense
    torch.cuda.empty_cache()
    for label, experts in (("dense", 0), ("moe", P20_EXPERTS)):
        losses = decoder_train_steps(dev, f"transformer train {label}", "transformer", (DEC_TRAIN_BATCH, DEC_FEATURES),
                                     decoder=dict(num_layers=2, num_experts=experts, moe_top_k=P20_TOP_K))
        if not losses[-1] < losses[0]:
            raise AssertionError(f"transformer train {label}: losses {losses} do not fall on one batch")
    more = transformer_maps(dev, tokenizer)
    return {k: counts[k] + more[k] for k in counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpucap_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    host_info()
    t0 = time.perf_counter()
    _build.build_all()
    t1 = time.perf_counter()
    _build.build_host("jpeg_decode")
    log(f"build: {t1 - t0:.2f} s for {sorted(_build.build_all())}, "
        f"then {time.perf_counter() - t1:.2f} s for jpeg_decode")

    fields = check_kernels(dev)
    fields["identity_block"] = check_identity_block(dev)
    fields["flash_attention"] = check_flash_attention(dev)
    fields.update(check_flash_attention_bwd(dev))
    counts, tokenizer = run_slice(dev)
    counts["identity_block"] = run_fused(dev, tokenizer)["identity_block"]
    counts["flash_attention"] = run_vit(dev, tokenizer)["flash_attention"]
    agreement(dev, tokenizer)
    agreement_encoders(dev, tokenizer)
    train_decoder(dev)
    trained = train_finetune(dev, tokenizer)
    counts["flash_attention_bwd_dkv"] = trained["flash_attention_bwd_dkv"]
    counts["flash_attention_bwd_dq"] = trained["flash_attention_bwd_dq"]
    train_agreement(dev, tokenizer)
    run_dataset(dev, tokenizer, check_jpeg_fixtures())
    pipe = make_pipeline("bf16", tokenizer)
    batches = run_evaluate(pipe)
    run_bundle(pipe, batches[0])
    run_fit_validation(pipe)
    del pipe, batches
    cli_root = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        return run_phases(dev, tokenizer, smi, counts, fields, cli_root)
    finally:
        shutil.rmtree(cli_root, ignore_errors=True)


def run_phases(dev, tokenizer, smi: str, counts: dict, fields: dict, cli_root: Path) -> int:
    """Phases 8-20 (phase 8's dataset and checkpoint in ``cli_root``, which
    phase 18 captions from), then the kernels line and the last line."""
    run_cli_workflow(dev, cli_root)
    for name, c in run_presets(dev, tokenizer).items():
        counts[name] += c
    t10 = time.perf_counter()
    with deterministic_torch("finetune dials"):
        dials = finetune_dials(dev, tokenizer)
    cli = run_finetune_cli(dev)
    for name in counts:
        counts[name] += dials[name] + cli[name]
    log(f"phase 10: {time.perf_counter() - t10:.2f} s")
    t11 = time.perf_counter()
    fitted = ema_fit(dev, tokenizer)
    optimizer_steps(dev)
    tuned = ema_finetune(dev, tokenizer)
    served = ema_cli(dev)
    for name in counts:
        counts[name] += fitted[name] + tuned[name] + served[name]
    log(f"phase 11: {time.perf_counter() - t11:.2f} s")
    t12 = time.perf_counter()
    sliced = run_slice8(dev, tokenizer)
    for name in counts:
        counts[name] += sliced[name]
    log(f"phase 12: {time.perf_counter() - t12:.2f} s")
    t13 = time.perf_counter()
    sliced = run_slice9(dev, tokenizer)
    for name in counts:
        counts[name] += sliced[name]
    log(f"phase 13: {time.perf_counter() - t13:.2f} s")
    t14 = time.perf_counter()
    sliced = run_slice10(dev, tokenizer)
    for name in counts:
        counts[name] += sliced[name]
    log(f"phase 14: {time.perf_counter() - t14:.2f} s")
    t15 = time.perf_counter()
    served = run_serving(dev, tokenizer)
    for name in counts:
        counts[name] += served[name]
    log(f"phase 15: {time.perf_counter() - t15:.2f} s")
    t16 = time.perf_counter()
    dialled = run_dials(dev, tokenizer)
    for name in counts:
        counts[name] += dialled[name]
    log(f"phase 16: {time.perf_counter() - t16:.2f} s")
    t17 = time.perf_counter()
    tooled = run_tools(dev, tokenizer, smi)
    for name in counts:
        counts[name] += tooled[name]
    log(f"phase 17: {time.perf_counter() - t17:.2f} s")
    t18 = time.perf_counter()
    kitted = run_toolkit(dev, tokenizer, smi, cli_root)
    for name in counts:
        counts[name] += kitted[name]
    log(f"phase 18: {time.perf_counter() - t18:.2f} s")
    t19 = time.perf_counter()
    decoded = run_decoders(dev, tokenizer)
    for name in counts:
        counts[name] += decoded[name]
    log(f"phase 19: {time.perf_counter() - t19:.2f} s")
    t20 = time.perf_counter()
    transformed = run_transformer(dev, tokenizer)
    for name in counts:
        counts[name] += transformed[name]
    log(f"phase 20: {time.perf_counter() - t20:.2f} s")

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": counts[name], **fields[name]}
        for name in REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
