// Family-scoring parity harness around the REFERENCE family stack.
//
// Compiles /root/reference/{kguts.cc,kmer_image.cc,kmer_encoder.cc,
// fasta_parser.cc,kmer.cc,family_mapper.cc} verbatim (boost/TBB shims in
// shim/) and drives the full family pipeline over artifacts written by
// OUR tooling:
//   * data dir (kmer.table.mem_map + function.index + otu.index),
//   * families.dat (9-column PATRIC format, kmer.cc:358-374),
//   * genus map (kmer.cc:338-355),
//   * families NR fasta — loaded here exactly as NRLoader/KmerInserter
//     ultimately do (nr_loader.cc:160-183 batches (kmer, fam) pairs that
//     kmer_inserter.cc:36-58 feeds to add_fam_mapping), just without the
//     thread machinery.
//
// Emits, per query protein on stdin, either the best_match_t stream
// format (family_mapper.h:70-75) prefixed by the query id, or with
// --all the find_all_matches report (family_mapper.cc:207-285), so
// scripts/ref_parity.py can diff family scoring against the JAX
// pipeline's core.family implementation.
//
// Usage: family_harness [--all] [--ambiguous] [--threshold N]
//            <data-dir> <families.dat> <genus.map> <nr.fa>
#include <boost/program_options.hpp>  // the shim

#define DEFINE_GLOBALS
#include "global.h"

#include <fstream>
#include <iostream>
#include <memory>
#include <string>

#include "fasta_parser.h"
#include "kguts.h"
#include "kmer.h"
// The harness must set kmer_hit_threshold_ / allow_ambiguous_functions_,
// which the reference hardcodes privately (family_mapper.h:57-61).
#define private public
#include "family_mapper.h"
#undef private

int main(int argc, char **argv) {
    auto *vm = new boost::program_options::variables_map();
    vm->set_int("n-family-file-threads", 2);
    g_parameters = vm;

    bool all_matches = false, ambiguous = false;
    unsigned int threshold = 3;
    std::vector<std::string> pos;
    for (int i = 1; i < argc; i++) {
        std::string a = argv[i];
        if (a == "--all") {
            all_matches = true;
        } else if (a == "--ambiguous") {
            ambiguous = true;
        } else if (a == "--threshold") {
            threshold = (unsigned int)std::stoul(argv[++i]);
        } else {
            pos.push_back(a);
        }
    }
    if (pos.size() != 4) {
        std::cerr << "Usage: " << argv[0]
                  << " [--all] [--ambiguous] [--threshold N]"
                  << " data-dir families.dat genus.map nr.fa\n";
        return 1;
    }
    const std::string &dir = pos[0], &fams = pos[1], &genus = pos[2],
                      &nr = pos[3];

    auto image = std::make_shared<KmerImage>(dir);
    KmerGuts kg(dir, image);

    auto mapping = std::make_shared<KmerPegMapping>();
    mapping->load_genus_map(genus);
    mapping->load_families(fams);

    // NR preload (single-threaded form of kserver.cc:96-126's
    // NRLoader + KmerInserter pipeline).
    {
        FastaParser fp;
        fp.set_callback([&](const std::string &id,
                            const std::string &seq) -> int {
            if (id.empty() && seq.empty())
                return 0;
            KmerPegMapping::encoded_id_t enc = mapping->encode_id(id);
            auto fit = mapping->peg_to_family_.find(enc);
            if (fit == mapping->peg_to_family_.end()) {
                std::cerr << "NO FAM FOR id='" << id << "'\n";
                return 0;
            }
            KmerPegMapping::encoded_family_id_t fam_id = fit->second;
            std::function<void(KmerGuts::hit_in_sequence_t)> cb =
                [&mapping, fam_id](KmerGuts::hit_in_sequence_t hit) {
                    mapping->add_fam_mapping(fam_id, hit.hit.which_kmer);
                };
            kg.process_aa_seq(id, seq, 0, cb, 0);
            return 0;
        });
        std::ifstream nrf(nr);
        fp.parse(nrf);
        std::cerr << "kmer_to_family_id_ size="
                  << mapping->kmer_to_family_id_.size() << "\n";
    }

    FastaParser fp;
    fp.set_callback([&](const std::string &id,
                        const std::string &seq) -> int {
        if (id.empty() && seq.empty())
            return 0;
        FamilyMapper fm(&kg, mapping);
        fm.kmer_hit_threshold_ = threshold;
        fm.allow_ambiguous_functions_ = ambiguous;
        if (all_matches) {
            fm.find_all_matches(std::cout, id, seq);
        } else {
            FamilyMapper::best_match_t m = fm.find_best_family_match(id, seq);
            std::cout << id << "\t" << m << "\n";
        }
        return 0;
    });
    fp.parse(std::cin);
    return 0;
}
